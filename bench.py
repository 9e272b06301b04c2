"""Benchmark: haplotype-threading DP throughput on one accelerator.

Prints ONE JSON line:
    {"metric": "dp_cells_per_s", "value": N, "unit": "cells/s",
     "vs_baseline": R, ...extras}

- "value": DP cells/s of the batched device threading DP (chains x positions x
  states x transition-states per BASELINE.md), steady-state, one chip.
- "vs_baseline": ratio against the native sequential C++ DP
  (native/dp_baseline.cpp — the reference-style single-core HaploThreader
  execution model) on this host, same workload per chain.
- extras: projection reads/s (containment matmul throughput) and raw
  numbers for the record.

Timing methodology: every measurement below (a) repeats the
workload K times *inside one jitted program* with a data dependency
threaded between iterations (so XLA cannot elide or overlap repeats),
(b) forces a host fetch of a scalar reduction of the outputs, and
(c) subtracts the measured dispatch+fetch round-trip time.  Medians over
several trials are reported.

Usage: python bench.py [--chains N] [--positions P] [--ploidy K] [--quick]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def make_dp_workload(num_chains: int, P: int, ploidy: int, seed: int = 0):
    from ahsoka_tpu.thread.states import (full_state_counts,
                                          full_state_validity, num_states)

    rng = np.random.default_rng(seed)
    M = 2 * ploidy
    K_CLUSTERS = 3 * ploidy
    counts_table = full_state_counts(ploidy)
    valid_table = full_state_validity(ploidy)

    ncand = np.full((num_chains, P), M, dtype=np.int32)
    geno = np.zeros((num_chains, P, 2), dtype=np.float32)
    geno[..., 0] = (ploidy + 1) // 2
    geno[..., 1] = ploidy // 2
    # vectorised: M distinct candidate clusters per position via argsort of
    # random keys, sorted ascending like the covmap construction
    keys = rng.random((num_chains, P, K_CLUSTERS))
    cands = np.sort(np.argsort(keys, axis=-1)[..., :M]).astype(np.int32)
    w = rng.random((num_chains, P, M)).astype(np.float32) + 0.05
    cov = w / w.sum(axis=-1, keepdims=True)
    cons = rng.integers(0, 2, size=(num_chains, P, M)).astype(np.int32)
    return (cands, ncand, cov, cons, geno, counts_table, valid_table,
            num_states(M, ploidy))


def measure_rtt(trials: int = 7) -> float:
    """Median dispatch+host-fetch round trip for a trivial program."""
    import jax
    import jax.numpy as jnp

    x = jnp.ones((8, 128), jnp.float32)
    f = jax.jit(lambda x: jnp.sum(x))
    np.asarray(f(x))
    ts = []
    for _ in range(trials):
        t0 = time.perf_counter()
        np.asarray(f(x))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def timed_seconds_per_call(make_rep, rtt: float, target_seconds: float = 1.0,
                           trials: int = 3, max_k: int = 65536) -> float:
    """Honest seconds per workload execution.

    make_rep(K) -> zero-arg jitted callable returning a small device array
    whose value depends on K sequential executions of the workload.  The
    result is fetched to host to force completion; RTT is subtracted.
    K grows geometrically until the device time clearly dominates the
    round trip, so tiny workloads are still resolved.
    """
    K = 1
    while True:
        rep = make_rep(K)
        np.asarray(rep())                    # compile + first run
        t0 = time.perf_counter()
        np.asarray(rep())
        t = time.perf_counter() - t0
        if t - rtt >= max(6 * rtt, 0.2) or K >= max_k:
            break
        # estimate the K that hits the target, grow at least 4x
        per = max((t - rtt) / K, 1e-7)
        K = int(min(max(target_seconds / per, K * 4), max_k))
    ts = []
    for _ in range(trials):
        t0 = time.perf_counter()
        np.asarray(rep())
        ts.append(time.perf_counter() - t0)
    return max(float(np.median(ts)) - rtt, 1e-9) / K


def _dp_rep_factory(args, ploidy: int):
    """make_rep(K) for the DP over a fixed device-resident workload.

    Each repeat perturbs the coverage input by 0 * (previous output) — a
    value-preserving data dependency XLA cannot fold away — so K repeats
    execute K real forward passes, every chain's final state consumed.
    """
    import jax
    import jax.numpy as jnp
    from ahsoka_tpu.thread.dp_jax import dp_forward_core

    ca, nc, co, cs, ge, ct, vt = args

    def one(co_i):
        fs, bp = jax.vmap(
            lambda a, n, c, s, g: dp_forward_core(
                a, n, c, s, g, ct, vt, ploidy=ploidy, num_alleles=2,
                switch_cost=32.0, affine_cost=8.0, cov_w=1.0, geno_w=1.0)
        )(ca, nc, co_i, cs, ge)
        return (fs.sum().astype(jnp.float32)
                + bp[0, 0, 0].astype(jnp.float32))

    def make_rep(K):
        @jax.jit
        def rep():
            def body(acc, _):
                return one(co + acc * 0.0), None
            acc, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=K)
            return acc
        return rep

    return make_rep


def bench_dp(cands, ncand, cov, cons, geno, counts_table, valid_table,
             S: int, ploidy: int, rtt: float | None = None):
    """Returns (cells_per_s, seconds_per_call) of the exact XLA scan's
    forward pass."""
    import jax.numpy as jnp

    num_chains, P, M = cands.shape
    if rtt is None:
        rtt = measure_rtt()
    a = [jnp.asarray(x) for x in
         (cands, ncand, cov, cons, geno, counts_table, valid_table)]
    sec = timed_seconds_per_call(_dp_rep_factory(a, ploidy), rtt)
    return num_chains * (P - 1) * S * S / sec, sec


def bench_dp_native(cands, ncand, cov, cons, geno, ploidy: int,
                    max_chains: int = 8):
    from ahsoka_tpu.thread._native_dp import (native_dp_available,
                                              run_native_dp)

    if not native_dp_available():
        return None
    num_chains = min(cands.shape[0], max_chains)
    t0 = time.perf_counter()
    total_cells = 0
    for c in range(num_chains):
        res = run_native_dp(cands[c], ncand[c], cov[c], cons[c], geno[c],
                            ploidy, 32.0, 8.0)
        total_cells += res[0]
    dt = time.perf_counter() - t0
    return total_cells / dt


def bench_projection(rtt: float, seed: int = 0):
    """Containment-matmul throughput in alignments/s (reads/s proxy)."""
    import jax
    import jax.numpy as jnp
    from ahsoka_tpu.project.device import containment_keys_core

    rng = np.random.default_rng(seed)
    B, APB, V, A, L, N, CHUNK = 512, 2, 2048, 1 << 15, 12, 1 << 13, 2048
    S = B * APB
    pf = np.zeros((S, V), dtype=np.int8)
    for s in range(S):
        pf[s, rng.choice(V, size=3, replace=False)] = 1
    pi = pf.copy()
    plf = pf.sum(axis=1).astype(np.int32)
    pli = plf.copy()
    pb = np.repeat(np.arange(B, dtype=np.int32), APB)
    pkb = np.tile((np.arange(APB, dtype=np.int32) << 23), B)
    nodes = rng.integers(0, V, size=(A, L), dtype=np.int32)
    name_id = rng.integers(0, N, size=A, dtype=np.int32)
    ident = rng.uniform(0.85, 1.0, size=A).astype(np.float32)

    args = (jnp.asarray(pf), jnp.asarray(pi), jnp.asarray(plf),
            jnp.asarray(pli), jnp.asarray(pb), jnp.asarray(pkb),
            jnp.asarray(nodes), jnp.asarray(name_id), jnp.asarray(ident))

    def make_rep(K):
        @jax.jit
        def rep():
            def body(acc, _):
                out = containment_keys_core(
                    *args, jnp.float32(90.0) + acc * 0.0,
                    num_bubbles=B, num_names=N, chunk=CHUNK,
                    alleles_per_bubble=APB)
                leaves = jax.tree_util.tree_leaves(out)
                acc = sum(l.reshape(-1)[0].astype(jnp.float32)
                          for l in leaves)
                return acc, None
            acc, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=K)
            return acc
        return rep

    sec = timed_seconds_per_call(make_rep, rtt)
    return A / sec


def bench_e2e_subprocess(config: str, timeout_s: int = 900):
    """Full-pipeline reads/s on a BASELINE-shaped synthetic input, in a
    subprocess with a hard wall-clock guard, so a stuck pipeline run
    cannot take the kernel bench down with it.  Returns the stage-breakdown
    dict; on timeout/failure returns {"error": reason} so the BENCH
    artifact records WHY the slice is missing instead of a silent null."""
    import os
    import subprocess

    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "scripts", "bench_e2e.py")
    try:
        out = subprocess.run(
            [sys.executable, script, "--config", config,
             "--outstem", os.path.join(os.path.dirname(script), "..",
                                       "benchdata", "bench_e2e", "run")],
            capture_output=True, text=True, timeout=timeout_s)
        if out.returncode != 0:
            msg = f"e2e subprocess failed: {out.stderr[-400:]}"
            sys.stderr.write(f"bench: {msg}\n")
            return {"error": msg, "config": config}
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                return json.loads(line)
        return {"error": "e2e subprocess printed no JSON",
                "config": config}
    except subprocess.TimeoutExpired:
        msg = f"exceeded {timeout_s}s wall-clock guard"
        sys.stderr.write(f"bench: e2e {config} {msg}; skipped\n")
        return {"error": msg, "config": config}
    except Exception as e:                          # noqa: BLE001
        sys.stderr.write(f"bench: e2e error: {e}\n")
        return {"error": str(e), "config": config}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--positions", type=int, default=1024)
    ap.add_argument("--ploidy", type=int, default=2)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--e2e", choices=["off", "auto", "config2", "config4"],
                    default="auto",
                    help="also run the full pipeline on a BASELINE-shaped "
                         "synthetic input and report per-stage seconds "
                         "(auto = a 100-chain chr20-shaped slice)")
    args = ap.parse_args()
    if args.quick:
        args.chains, args.positions = 32, 128

    from ahsoka_tpu.utils.xla_cache import \
        enable_persistent_compilation_cache
    enable_persistent_compilation_cache()

    # e2e runs FIRST, before this process touches the device: a JAX
    # process reserves most of the card's memory, so the subprocess must
    # not share the card with a connected parent
    e2e = None
    if args.e2e != "off" and not args.quick:
        e2e = bench_e2e_subprocess(
            "bench" if args.e2e == "auto" else args.e2e)

    (cands, ncand, cov, cons, geno, counts_table, valid_table,
     S) = make_dp_workload(args.chains, args.positions, args.ploidy)

    rtt = measure_rtt()
    cells_per_s, step_s = bench_dp(
        cands, ncand, cov, cons, geno, counts_table, valid_table, S,
        args.ploidy, rtt=rtt)
    native_cells_per_s = bench_dp_native(cands, ncand, cov, cons, geno,
                                         args.ploidy)
    reads_per_s = bench_projection(rtt)

    # tetraploid entry (BASELINE.md tracks both ploidies): the exact scan
    # at 128 chains x 256 positions, S=330
    tetra = None
    if args.ploidy == 2 and not args.quick:
        w = make_dp_workload(128, 256, 4)
        tetra, _sec = bench_dp(*w[:7], w[7], 4, rtt=rtt)

    vs = cells_per_s / native_cells_per_s if native_cells_per_s else None
    import jax

    # bulk extras (the fresh e2e run) go to a sidecar file: embedding
    # them in the stdout line pushed the headline numbers past a log
    # capture window — the final printed line must stay compact and
    # parseable
    import os
    extras_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "benchdata",
        "bench_extras.json")
    try:
        os.makedirs(os.path.dirname(extras_path), exist_ok=True)
        with open(extras_path, "w") as fh:
            json.dump({"e2e": e2e}, fh, indent=1)
    except Exception as exc:                        # noqa: BLE001
        sys.stderr.write(f"bench: extras sidecar unwritable: {exc}\n")
        extras_path = None

    print(json.dumps({
        "metric": "dp_cells_per_s",
        "value": round(cells_per_s, 1),
        "unit": "cells/s",
        "vs_baseline": round(vs, 3) if vs else None,
        "baseline_native_cells_per_s": round(native_cells_per_s, 1)
        if native_cells_per_s else None,
        "projection_reads_per_s": round(reads_per_s, 1)
        if reads_per_s else None,
        "tetraploid_cells_per_s": round(tetra, 1) if tetra else None,
        "dp_step_seconds": round(step_s, 6),
        "host_rtt_seconds": round(rtt, 6),
        "e2e_ok": bool(e2e) and "error" not in (e2e or {}),
        "extras_file": extras_path,
        "chains": args.chains, "positions": args.positions,
        "ploidy": args.ploidy, "kernel": "scan",
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
