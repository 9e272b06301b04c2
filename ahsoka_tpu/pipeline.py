"""Pipeline orchestration (the reference's driver, src/polyassembly.cpp).

Stage graph:

    parse GFA -> find bubbles -> [only-bubbles: write -bubbleinfo.txt, stop]
              -> parse GAF -> enumerate allele paths -> per-chain phasing
              -> result files

Per-chain phasing (projection, scoring, clustering, threading DP, emission)
lives in phase.py; this module wires I/O and ordering.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

from ahsoka_tpu.config import PhasingConfig
from ahsoka_tpu.emit.bubbleinfo import write_bubbleinfo_file
from ahsoka_tpu.graph.alleles import AllelePathTable, enumerate_allele_paths
from ahsoka_tpu.graph.bubbles import find_bubbles
from ahsoka_tpu.graph.structures import BubbleIndex
from ahsoka_tpu.io.gaf import (AlignmentTable, identities_sidefile_path,
                               read_gaf)
from ahsoka_tpu.io.gfa import GfaGraph, parse_gfa
from ahsoka_tpu.utils.logging import get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class PipelineArtifacts:
    graph: GfaGraph
    index: BubbleIndex
    alignments: Optional[AlignmentTable] = None
    allele_paths: Optional[AllelePathTable] = None
    size_sorting: Optional[List[Tuple[int, int]]] = None
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    # columnar alignment tables (jax backend fast path; object tables above
    # remain the oracle and the host-backend input)
    gaf_columns: Optional[object] = None
    chain_buckets: Optional[Dict[int, object]] = None

    def chain_alignment_count(self, chain_id: int) -> int:
        if self.chain_buckets is not None:
            b = self.chain_buckets.get(chain_id)
            return 0 if b is None else len(b.record_idx)
        return len(self.alignments.chain_alignments(chain_id))


def load_graph_and_bubbles(gfa_path: str, config: PhasingConfig,
                           artifacts: Optional[PipelineArtifacts] = None
                           ) -> PipelineArtifacts:
    t0 = time.perf_counter()
    graph = parse_gfa(gfa_path)
    t1 = time.perf_counter()
    log.info("Step 1: Graph with %d nodes read", graph.num_nodes())
    index = find_bubbles(graph,
                         compat_std_ordering=config.compat_std_ordering)
    t2 = time.perf_counter()
    log.info("Step 2: Bubbles read; number of bubble chains: %d",
             len(index.chains))
    art = PipelineArtifacts(graph=graph, index=index)
    art.stage_seconds["parse_gfa"] = t1 - t0
    art.stage_seconds["find_bubbles"] = t2 - t1
    return art


def run_only_bubbles(gfa_path: str, outstem: str,
                     config: PhasingConfig = PhasingConfig()) -> str:
    """The ``only-bubbles`` subcommand (src/polyassembly.cpp:112-114)."""
    art = load_graph_and_bubbles(gfa_path, config)
    return write_bubbleinfo_file(art.index, outstem)


def _secondary_process(config: PhasingConfig) -> bool:
    """True on non-zero ranks of a chain-sharded multi-process run:
    shared side files (bubbleinfo, identities, the aggregate) are
    written by rank 0 only — concurrent identical writers would race on
    the shared filesystem."""
    if not getattr(config, "process_chain_sharding", False):
        return False
    import jax
    if not jax.distributed.is_initialized():
        # a library caller that skipped the CLI's initialize_distributed:
        # jax.process_count() is 1 here even when sibling processes are
        # running, so the rank-0-only serialization this helper provides
        # cannot engage — make that visible instead of silently racing
        log.warning(
            "process_chain_sharding is set but jax.distributed was "
            "never initialized; treating this as a single-process run "
            "(rank-0-only side-file serialization inactive). Call "
            "jax.distributed.initialize (or use the CLI's --coordinator/"
            "--num-processes flags) before run_phase for multi-process "
            "layouts.")
        return False
    return jax.process_count() > 1 and jax.process_index() > 0


def prepare_phase_inputs(gfa_path: str, gaf_path: str, outstem: str,
                         config: PhasingConfig,
                         columnar: bool = False) -> PipelineArtifacts:
    """Stages 1-4: graph, bubbles, alignments, allele paths, chain order.

    ``columnar=True`` parses the GAF into flat column arrays (native
    parser) and buckets by chain with vectorised numpy — no per-record
    objects; used by the jax backend for large inputs."""
    art = load_graph_and_bubbles(gfa_path, config)
    secondary = _secondary_process(config)
    if not secondary:
        write_bubbleinfo_file(art.index, outstem)

    t0 = time.perf_counter()
    if columnar:
        from ahsoka_tpu.io._native_io import parse_gaf_native
        from ahsoka_tpu.io.columns import (bucket_by_chain,
                                           columns_from_native)

        raw = parse_gaf_native(gaf_path)
        cols = columns_from_native(raw) if raw is not None else None
        if cols is not None:
            art.gaf_columns = cols
            art.chain_buckets = bucket_by_chain(
                cols, art.index,
                compat_duplicate_bucketing=
                config.compat_duplicate_bucketing)
            art.alignments = AlignmentTable(num_records=cols.num_records)
            # identities side file from the same raw native arrays
            if not secondary:
                _write_identities_from_native(gaf_path, raw=raw)
        else:
            log.warning("native GAF parser unavailable; falling back to "
                        "the object parser")
            columnar = False
    if not columnar:
        import contextlib
        import os
        idf_ctx = (open(identities_sidefile_path(gaf_path), "w")
                   if not secondary else open(os.devnull, "w"))
        with contextlib.closing(idf_ctx) as idf:
            art.alignments = read_gaf(
                gaf_path, art.index, identities_out=idf,
                compat_duplicate_bucketing=
                config.compat_duplicate_bucketing)
    t1 = time.perf_counter()
    n_buckets = (sum(len(b.record_idx)
                     for b in art.chain_buckets.values())
                 if art.chain_buckets is not None else
                 sum(len(v) for v in art.alignments.by_chain.values()))
    log.info("Step 3: Alignments read; number of alignment buckets: %d",
             n_buckets)

    art.allele_paths = enumerate_allele_paths(art.graph, art.index)
    t2 = time.perf_counter()
    log.info("Step 4: Chain paths computed; number of chain paths: %d",
             len(art.allele_paths))

    # process largest chains first; ties broken by larger chain id — the
    # deterministic order produced by sorting (size, chain_id) pairs
    # descending (src/polyassembly.cpp:136-140)
    art.size_sorting = sorted(
        ((len(bubbles), chain_id)
         for chain_id, bubbles in art.allele_paths.items()),
        reverse=True)
    art.stage_seconds["parse_gaf"] = t1 - t0
    art.stage_seconds["allele_paths"] = t2 - t1
    return art


def _write_identities_from_native(gaf_path: str, raw=None) -> None:
    """Identities side file (src/alignmentreader.cpp:73-75,151-156) from
    the native parser's flat arrays.  Vectorised: segment names are
    comma-joined once in a single numpy pass (the naive per-record loop
    cost ~40s on a 1M-record GAF), then each line is cheap byte slicing.
    """
    import numpy as np

    from ahsoka_tpu.io._native_io import parse_gaf_native

    cols = raw if raw is not None else parse_gaf_native(gaf_path)
    if cols is None:
        return
    nb, no = bytes(cols["name_bytes"]), cols["name_offsets"]
    sb, so = cols["seg_bytes"], np.asarray(cols["seg_offsets"],
                                           dtype=np.int64)
    bb, bo = bytes(cols["blocklen_bytes"]), cols["blocklen_offsets"]
    po = cols["path_offsets"]
    idents = cols["identities"]
    n_segs = len(so) - 1
    # one pass: seg blob with a ',' appended after every segment, so a
    # record's "s1,s2,...," field is a single slice
    joined = np.empty(len(sb) + n_segs, dtype=np.uint8)
    new_off = so + np.arange(len(so), dtype=np.int64)  # +1 comma per seg
    comma_pos = new_off[1:] - 1
    mask = np.ones(len(joined), dtype=bool)
    mask[comma_pos] = False
    joined[mask] = np.frombuffer(sb, dtype=np.uint8)
    joined[comma_pos] = ord(",")
    joined_b = joined.tobytes()
    ident_str = np.char.mod("%g", np.asarray(idents))
    with open(identities_sidefile_path(gaf_path), "wb") as fh:
        write = fh.write
        for r in range(cols["num_records"]):
            write(nb[no[r]:no[r + 1]])
            write(b"\t")
            write(ident_str[r].encode())
            write(b"\t")
            # slice spans segments po[r]..po[r+1], trailing comma included
            # (reference field format)
            write(joined_b[new_off[po[r]]:new_off[po[r + 1]]])
            write(b"\t")
            write(bb[bo[r]:bo[r + 1]])
            write(b"\n")


def run_phase(gfa_path: str, gaf_path: str, outstem: str,
              config: PhasingConfig = PhasingConfig(),
              backend: Optional[str] = None, resume: bool = False,
              keep_going: bool = False,
              profile_dir: Optional[str] = None,
              columnar: Optional[bool] = None) -> PipelineArtifacts:
    """The full ``phase`` subcommand.

    ``profile_dir`` captures a jax.profiler trace of the phasing stage
    (viewable in TensorBoard/XProf) — the observability the reference
    lacks entirely (SURVEY.md §5 "tracing/profiling")."""
    from ahsoka_tpu.phase import phase_all_chains
    from ahsoka_tpu.utils.malloc_tune import retain_freed_heap
    from ahsoka_tpu.utils.xla_cache import \
        enable_persistent_compilation_cache

    enable_persistent_compilation_cache()
    retain_freed_heap()
    if columnar is None:
        columnar = (backend or config.backend) == "jax" \
            and not config.debug_readset_files
    use_backend = backend or config.backend
    # validate the backend/sharding combination BEFORE the (possibly
    # minutes-long) input parse: a misconfigured multi-host run should
    # fail at startup, not after reading the whole GAF
    if config.process_chain_sharding and not (use_backend == "jax"
                                              and config.batch_dp):
        raise ValueError("process_chain_sharding requires the batched "
                         "jax driver (backend='jax', batch_dp=True)")
    art = prepare_phase_inputs(gfa_path, gaf_path, outstem, config,
                               columnar=columnar)
    if use_backend == "jax":
        # isolate the per-process device handshake from the phase timer
        # on every jax-backend path (batched or not), so rate counters
        # stay comparable across drivers
        from ahsoka_tpu.phase import device_warmup
        device_warmup(art.stage_seconds)
    t0 = time.perf_counter()
    if profile_dir:
        import jax

        jax.profiler.start_trace(profile_dir)
    try:
        if use_backend == "jax" and config.batch_dp:
            from ahsoka_tpu.phase import phase_all_chains_batched

            results = phase_all_chains_batched(
                art, outstem, config, resume=resume,
                keep_going=keep_going)
        else:
            results = phase_all_chains(art, outstem, config,
                                       backend=use_backend,
                                       resume=resume,
                                       keep_going=keep_going)
    finally:
        if profile_dir:
            import jax

            jax.profiler.stop_trace()
    art.stage_seconds["phase"] = time.perf_counter() - t0
    log.info("Step 5: Phasing processed")
    _write_metrics(outstem, art, results, config)
    return art


def device_identity(backend: str) -> dict:
    """Which devices a run used: ``platform``, ``device_kind``,
    ``device_count`` and this process's ``local_device_ids`` as jax
    reports them (None on the host backend, which runs no device
    program)."""
    if backend != "jax":
        return {"platform": None, "device_kind": None, "device_count": 0,
                "local_device_ids": []}
    import jax
    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "local_device_ids": [d.id for d in jax.local_devices()]}


def _write_metrics(outstem: str, art: PipelineArtifacts, results,
                   config: PhasingConfig) -> None:
    """Structured run metrics: per-stage wall-clock, per-chain stats, and
    the throughput counters BASELINE.md tracks (reads/s, DP cells/s)."""
    import json

    # backend client start-up (stage_seconds.device_warmup) is measured
    # BEFORE the phase timer starts, so the phase stage — and the rate
    # counters derived from it — exclude it while stage_seconds keeps it
    # visible
    phase_s = art.stage_seconds.get("phase", 0.0) or 1e-9
    # reads/s for BASELINE comparisons covers the whole record path: GAF
    # parse + phasing (the reference's hot loops #1-#4, SURVEY.md §3.5) —
    # not just the phase stage, which excludes the parse the same records
    # paid for.  The phase-only rate is kept as a separate counter.
    e2e_s = phase_s + art.stage_seconds.get("parse_gaf", 0.0)
    total_reads = sum(r.num_reads for r in results)
    total_cells = sum(r.dp_cells for r in results)
    num_records = art.alignments.num_records if art.alignments else 0
    dp_window = art.stage_seconds.get("dp_device_window")
    metrics = {
        # schema markers.  v2: rate counters exclude the device handshake
        # (stage_seconds.device_warmup); v1 files (no marker) charged it
        # to the first device stage.  v3: the DP throughput counter is
        # split — `dp_cells_per_s_e2e` divides by the whole phase wall
        # (dispatch, host stages, emission included), while
        # `dp_cells_per_s_device_window` divides by the batched device
        # DP program's own dispatch->completion window; publishing one
        # number under one name conflated quantities 7 orders apart
        "metrics_version": 3,
        "rate_excludes_device_warmup": True,
        "stage_seconds": art.stage_seconds,
        "ploidy": config.ploidy,
        "backend": config.backend,
        **device_identity(config.backend),
        "num_chains": len(results),
        "chains_phased": sum(1 for r in results if not r.skipped),
        "chains_skipped": sum(1 for r in results if r.skipped),
        "chains_failed": sum(1 for r in results if r.error),
        "gaf_records": num_records,
        "total_filtered_reads": total_reads,
        "total_dp_cells": total_cells,
        "reads_per_s": num_records / e2e_s,
        "reads_per_s_phase_only": num_records / phase_s,
        "dp_cells_per_s_e2e": total_cells / phase_s,
        "dp_cells_per_s_device_window": (
            total_cells / dp_window if dp_window else None),
        "chains": [
            {"chain_id": r.chain_id, "bubbles": r.num_bubbles,
             "reads": r.num_reads, "clusters": r.num_clusters,
             "positions": r.num_positions, "seconds": round(r.seconds, 4),
             "stage_seconds": {k: round(v, 4)
                               for k, v in r.stage_seconds.items()},
             "skipped": r.skipped, "reason": r.reason, "error": r.error,
             "resumed": r.resumed}
            for r in results],
    }
    path = f"{outstem}-metrics.json"
    if _secondary_process(config):
        # chain-sharded multi-process: each rank reports its own share;
        # rank 0 keeps the canonical filename
        import jax
        path = f"{outstem}-metrics.rank{jax.process_index()}.json"
        metrics["process_index"] = jax.process_index()
        metrics["process_count"] = jax.process_count()
    with open(path, "w") as fh:
        json.dump(metrics, fh, indent=1)
