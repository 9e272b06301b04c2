"""Projection as a device tensor program.

The reference's hot loops #1/#2 (SURVEY.md §3.3: the triple loop
bubble x allele x alignment with per-pair ``is_subset``,
src/alignmentstoreadset.cpp:106-133,221-252) become two int8 matmuls plus
packed-key min-reductions:

1. **Containment matmul.**  Chain vocabulary V = nodes of the chain's
   allele paths.  ``P[s, v]`` one-hot of path s over V (full or inner
   nodes), ``A[a, v]`` membership of alignment a.  Then

       contained(s, a)  <=>  (P @ A^T)[s, a] == |path s|

   — an int8 matmul with int32 accumulation.  Alignments
   are processed in chunks so the A matrix never materialises beyond
   [chunk, V].

2. **First-match reduction.**  The reference's ordered loops mean "first
   (allele, alignment) match wins" per (position, read-name).  We pack the
   order into one int32 key ``allele << AL_BITS | alignment_index``,
   segment-min over paths by bubble, then scatter-min into a dense
   [bubbles, names] key table by read name.  Winners decode back to
   (allele, alignment) on the host, which then assembles the identical
   ReadSet the host oracle produces (tests assert equality).

The assembled readsets feed scoring/clustering/threading unchanged.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ahsoka_tpu.config import PhasingConfig
from ahsoka_tpu.io.gaf import Alignment
from ahsoka_tpu.project.readset import (ChainReadsets, Read, ReadSet,
                                        _filter, partial_inner,
                                        partial_position_sweep)
from ahsoka_tpu.utils.logging import get_logger

log = get_logger(__name__)

AL_BITS = 23                    # alignment index bits in the packed key
MAX_ALLELE = (1 << (31 - AL_BITS)) - 1
MAX_ALN = (1 << AL_BITS) - 1
NO_MATCH = np.int32(2 ** 31 - 1)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _bucket(x: int, minimum: int = 128) -> int:
    """Next power of two (>= minimum): pads shapes into a logarithmic
    family of buckets so per-chain kernels share compile-cache entries
    instead of recompiling for every distinct chain size."""
    b = minimum
    while b < x:
        b *= 2
    return b


class SparseOnehot:
    """COO form of a 0/1 path-node table (logically int8 [S, V]).

    Big chains never materialise the dense onehots: a 10k-bubble,
    50k-node-vocab chain's two tables are 2 GB of host zeros at ~0.3%
    occupancy, and the device path scatters the COO coordinates
    directly (_scatter_onehot)."""

    __slots__ = ("shape", "r", "c")
    dtype = np.dtype(np.int8)

    def __init__(self, shape, r, c):
        self.shape = shape
        self.r = np.asarray(r, dtype=np.int64)
        self.c = np.asarray(c, dtype=np.int64)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.int8)
        out[self.r, self.c] = 1
        return out


# above this many cells the path onehots stay COO (SparseOnehot)
_DENSE_ONEHOT_CELLS = 1 << 26


def _onehot_repr(shape, r, c):
    if shape[0] * shape[1] > _DENSE_ONEHOT_CELLS:
        return SparseOnehot(shape, r, c)
    out = np.zeros(shape, dtype=np.int8)
    out[r, c] = 1
    return out


@dataclasses.dataclass
class ChainDeviceInputs:
    """Host-prepared padded arrays for one chain's projection."""
    # paths (full + inner variants share the same (bubble, allele)
    # layout); SparseOnehot above _DENSE_ONEHOT_CELLS
    path_onehot_full: "np.ndarray | SparseOnehot"   # int8 [S, V]
    path_onehot_inner: "np.ndarray | SparseOnehot"  # int8 [S, V]
    path_len_full: np.ndarray       # int32 [S]
    path_len_inner: np.ndarray      # int32 [S]
    path_bubble: np.ndarray         # int32 [S] dense bubble index
    path_key_base: np.ndarray       # int32 [S] allele << AL_BITS
    bubble_ids: np.ndarray          # int32 [B] bubble ids (sorted)
    # alignments
    aln_vocab_nodes: np.ndarray     # int32 [A, L] vocab indices, -1 pad
    aln_name_id: np.ndarray         # int32 [A]
    aln_identity: np.ndarray        # float32 [A]
    names: List[str]
    num_paths: int
    num_alignments: int


def _path_tables(bubble_paths: Dict[int, List[List[int]]]):
    bubble_ids = sorted(bubble_paths)
    flat: List[Tuple[int, int, List[int]]] = []
    for b_idx, b in enumerate(bubble_ids):
        for allele, path in enumerate(bubble_paths[b]):
            if allele > MAX_ALLELE:
                raise ValueError("allele index exceeds packed-key capacity")
            flat.append((b_idx, allele, path))
    vocab: Dict[int, int] = {}
    for _, _, path in flat:
        for n in path:
            vocab.setdefault(n, len(vocab))
    return bubble_ids, flat, vocab


def _build_path_tables(flat, vocab):
    """Shared path-table construction: COO onehots (dense below the
    threshold), lengths, bubble index, packed-key base."""
    S, V = len(flat), max(len(vocab), 1)
    path_len_full = np.zeros(S, dtype=np.int32)
    path_len_inner = np.zeros(S, dtype=np.int32)
    path_bubble = np.zeros(S, dtype=np.int32)
    path_key_base = np.zeros(S, dtype=np.int32)
    fr: List[int] = []
    fc: List[int] = []
    ir: List[int] = []
    ic: List[int] = []
    for s, (b_idx, allele, path) in enumerate(flat):
        uniq = set(path)
        for n in uniq:
            fr.append(s)
            fc.append(vocab[n])
        path_len_full[s] = len(uniq)
        inner = set(partial_inner(path))
        for n in inner:
            ir.append(s)
            ic.append(vocab[n])
        path_len_inner[s] = len(inner)
        path_bubble[s] = b_idx
        path_key_base[s] = allele << AL_BITS
    return (_onehot_repr((S, V), fr, fc), _onehot_repr((S, V), ir, ic),
            path_len_full, path_len_inner, path_bubble, path_key_base)


def prepare_chain_inputs(bubble_paths: Dict[int, List[List[int]]],
                         alignments: Sequence[Alignment]
                         ) -> ChainDeviceInputs:
    bubble_ids, flat, vocab = _path_tables(bubble_paths)
    S = len(flat)
    (path_onehot_full, path_onehot_inner, path_len_full, path_len_inner,
     path_bubble, path_key_base) = _build_path_tables(flat, vocab)

    if len(alignments) > MAX_ALN:
        raise ValueError("alignment count exceeds packed-key capacity")
    names: List[str] = []
    name_index: Dict[str, int] = {}
    L = max((len(set(a.node_ids)) for a in alignments), default=1)
    A = len(alignments)
    aln_vocab_nodes = np.full((A, L), -1, dtype=np.int32)
    aln_name_id = np.zeros(A, dtype=np.int32)
    aln_identity = np.zeros(A, dtype=np.float32)
    for i, aln in enumerate(alignments):
        if aln.name not in name_index:
            name_index[aln.name] = len(names)
            names.append(aln.name)
        aln_name_id[i] = name_index[aln.name]
        aln_identity[i] = aln.identity
        k = 0
        for n in set(aln.node_ids):
            v = vocab.get(n)
            if v is not None:
                aln_vocab_nodes[i, k] = v
                k += 1
    return ChainDeviceInputs(
        path_onehot_full=path_onehot_full,
        path_onehot_inner=path_onehot_inner,
        path_len_full=path_len_full, path_len_inner=path_len_inner,
        path_bubble=path_bubble, path_key_base=path_key_base,
        bubble_ids=np.asarray(bubble_ids, dtype=np.int32),
        aln_vocab_nodes=aln_vocab_nodes, aln_name_id=aln_name_id,
        aln_identity=aln_identity, names=names,
        num_paths=S, num_alignments=A)


def prepare_chain_inputs_from_columns(bubble_paths, cols, bucket
                                      ) -> ChainDeviceInputs:
    """Columnar variant of prepare_chain_inputs: builds the device inputs
    from GafColumns + a ChainBucket with vectorised numpy (no per-record
    Python objects; the batched jax backend's data path)."""
    bubble_ids, flat, vocab = _path_tables(bubble_paths)
    S = len(flat)
    (path_onehot_full, path_onehot_inner, path_len_full, path_len_inner,
     path_bubble, path_key_base) = _build_path_tables(flat, vocab)

    # The reference buckets an alignment once per path node in the chain
    # (src/alignmentreader.cpp:176-183).  For containment the duplicates
    # are pure redundancy: every copy has the same node set/name/identity,
    # so first-match winners and creation order are invariant under an
    # order-preserving dedup (bucket entries are ascending -> np.unique
    # keeps first-occurrence order; packed keys remap monotonically).
    # Dropping them shrinks the kernel's alignment axis by ~|path| x.
    entries = np.unique(bucket.record_idx)
    A = len(entries)
    if A > MAX_ALN:
        raise ValueError("alignment count exceeds packed-key capacity")
    identities = cols.identities[entries].astype(np.float32)
    gnames = cols.record_name[entries]
    uniq_names, name_id = np.unique(gnames, return_inverse=True)
    names = [cols.names[int(g)] for g in uniq_names]

    # vocab-mapped node rows for the unique records, gathered raggedly
    uniq_recs, rec_inv = np.unique(entries, return_inverse=True)
    off = cols.path_offsets
    starts = off[uniq_recs]
    lens = (off[uniq_recs + 1] - starts).astype(np.int64)
    total = int(lens.sum()) if len(lens) else 0
    L = int(lens.max()) if len(lens) else 1
    if total:
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(lens) - lens, lens)
        flat_idx = np.repeat(starts, lens) + within
        nodes_concat = cols.node_ids[flat_idx]
        vocab_ids = np.fromiter(vocab.keys(), dtype=np.int64,
                                count=len(vocab))
        vocab_vals = np.arange(len(vocab), dtype=np.int64)
        sort = np.argsort(vocab_ids)
        vocab_ids, vocab_vals = vocab_ids[sort], vocab_vals[sort]
        pos = np.clip(np.searchsorted(vocab_ids, nodes_concat), 0,
                      max(len(vocab_ids) - 1, 0))
        mapped = np.where(vocab_ids[pos] == nodes_concat,
                          vocab_vals[pos], -1)
        per_rec = np.full((len(uniq_recs), L), -1, dtype=np.int32)
        rows = np.repeat(np.arange(len(uniq_recs)), lens)
        per_rec[rows, within] = mapped
    else:
        per_rec = np.full((max(len(uniq_recs), 1), L), -1, dtype=np.int32)
    aln_vocab_nodes = per_rec[rec_inv] if A else \
        np.full((0, L), -1, dtype=np.int32)

    return ChainDeviceInputs(
        path_onehot_full=path_onehot_full,
        path_onehot_inner=path_onehot_inner,
        path_len_full=path_len_full, path_len_inner=path_len_inner,
        path_bubble=path_bubble, path_key_base=path_key_base,
        bubble_ids=np.asarray(bubble_ids, dtype=np.int32),
        aln_vocab_nodes=aln_vocab_nodes,
        aln_name_id=name_id.astype(np.int32),
        aln_identity=identities, names=names,
        num_paths=S, num_alignments=A)


def containment_keys_core(path_onehot_full, path_onehot_inner,
                          path_len_full, path_len_inner,
                          path_bubble, path_key_base,
                          aln_vocab_nodes, aln_name_id, aln_identity,
                          gate_mask_value, num_bubbles: int, num_names: int,
                          chunk: int, alleles_per_bubble: int = 0):
    """Device kernel: containment matmuls + packed-key reductions.

    Returns int32 key tables [B, N] for (full, partial, partial-gated);
    NO_MATCH where no (allele, alignment) matched.  Pure traced function —
    jitted below, wrapped in shard_map by dist/step.py (alignment axis is
    the data-parallel axis; per-shard tables merge with a min collective).

    ``alleles_per_bubble > 0`` declares the uniform path layout (row
    s = b * alleles_per_bubble + allele_rank, S == B * A_max): the
    per-bubble min is then a reshape+min instead of the scatter-lowered
    segment_min, which remains the ragged fallback.
    """
    S, V = path_onehot_full.shape
    A, L = aln_vocab_nodes.shape
    num_chunks = A // chunk

    # node tables may arrive int16 (halves the host->device transfer);
    # widen on device
    aln_vocab_nodes = aln_vocab_nodes.astype(jnp.int32)
    pf = path_onehot_full.astype(jnp.int8)
    pi = path_onehot_inner.astype(jnp.int8)

    def process_chunk(carry, c):
        start = c * chunk
        nodes = jax.lax.dynamic_slice(aln_vocab_nodes, (start, 0),
                                      (chunk, L))
        name_ids = jax.lax.dynamic_slice(aln_name_id, (start,), (chunk,))
        ident = jax.lax.dynamic_slice(aln_identity, (start,), (chunk,))
        # membership [chunk, V]: compare-any over the (small) node axis —
        # no scatter, dedups duplicate nodes like the set() host oracle
        iota_v = jax.lax.broadcasted_iota(jnp.int32, (1, 1, V), 2)
        member = (nodes[:, :, None] == iota_v).any(axis=1).astype(jnp.int8)
        # [S, V] @ [V, chunk] with int32 accumulation
        hits_full = jax.lax.dot_general(
            pf, member.T, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)
        hits_inner = jax.lax.dot_general(
            pi, member.T, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)
        cont_full = hits_full == path_len_full[:, None]
        cont_inner = hits_inner == path_len_inner[:, None]

        al_idx = start + jax.lax.broadcasted_iota(jnp.int32, (S, chunk), 1)
        key = path_key_base[:, None] + al_idx

        def reduce_keys(contained, extra_mask):
            k = jnp.where(contained & extra_mask, key, NO_MATCH)
            if alleles_per_bubble:
                return k.reshape(num_bubbles, alleles_per_bubble,
                                 chunk).min(axis=1)
            return jax.ops.segment_min(
                k, path_bubble, num_segments=num_bubbles,
                indices_are_sorted=True)

        ones = jnp.ones((1, chunk), dtype=bool)
        gate = (ident * 100.0 > gate_mask_value)[None, :]
        pb3 = jnp.stack([reduce_keys(cont_full, ones),
                         reduce_keys(cont_inner, ones),
                         reduce_keys(cont_inner, gate)])   # [3, B, chunk]
        # one fused scatter-min into [3, B, N] by name
        return carry.at[:, :, name_ids].min(pb3), None

    init = jnp.full((3, num_bubbles, num_names), NO_MATCH, dtype=jnp.int32)
    keys3, _ = jax.lax.scan(process_chunk, init, jnp.arange(num_chunks))
    return keys3[0], keys3[1], keys3[2]


_containment_keys = functools.partial(
    jax.jit, static_argnames=("num_bubbles", "num_names", "chunk",
                              "alleles_per_bubble"))(
    containment_keys_core)


def _onehot_coo(oh) -> tuple:
    """(rows, cols) of a dense or SparseOnehot path table."""
    if isinstance(oh, SparseOnehot):
        return oh.r, oh.c
    r, c = np.nonzero(oh)
    return r, c


def _padded_chain_arrays(inputs: ChainDeviceInputs, chunk: int = 1024,
                         dense_onehots: bool = True):
    """Pad one chain's arrays into the bucketed kernel layout.

    Returns (arrays, statics): ``arrays`` = (pf, pi, plf, pli, pb, pkb,
    nodes, name_id, ident), ``statics`` = (num_bubbles, num_names, chunk,
    alleles_per_bubble).  Chains with equal array shapes + statics can be
    stacked on a leading axis and run in one vmapped kernel call.

    ``dense_onehots=False`` returns pf/pi as padded SparseOnehot COO
    (the blocked big-chain path scatters them on device; the multi-GB
    dense padded tables are never built)."""
    A = inputs.num_alignments
    chunk = min(chunk, _round_up(max(A, 1), 256))
    A_pad = _round_up(max(A, 1), chunk)
    pad = A_pad - A
    nodes = np.pad(inputs.aln_vocab_nodes, ((0, pad), (0, 0)),
                   constant_values=-1)
    # padded alignments point at a sacrificial extra name slot
    name_id = np.pad(inputs.aln_name_id, (0, pad),
                     constant_values=len(inputs.names))
    ident = np.pad(inputs.aln_identity, (0, pad), constant_values=0.0)
    # bucket the table shapes (and the path/vocab axes) so chains of
    # similar size share one compiled kernel
    B = len(inputs.bubble_ids)
    N = len(inputs.names) + 1
    B_pad, N_pad = _bucket(B, 64), _bucket(N, 128)
    S, V = inputs.path_onehot_full.shape
    V_pad = _bucket(V, 128)
    L = nodes.shape[1]
    L_pad = _bucket(L, 8)
    counts = np.bincount(inputs.path_bubble, minlength=B) if S else \
        np.ones(B, dtype=np.int64)
    amax = int(counts.max()) if B else 1
    if amax <= 16:
        # uniform layout: row s = b * A_max + allele rank; the kernel's
        # per-bubble min becomes a reshape+min instead of a segment_min
        apb = _bucket(max(amax, 1), 2)
        S_pad = B_pad * apb
        offsets = np.concatenate([[0], np.cumsum(counts)])
        rank = np.arange(S) - offsets[inputs.path_bubble]
        rows = inputs.path_bubble.astype(np.int64) * apb + rank
        plf = np.full(S_pad, np.int32(2 ** 30), dtype=np.int32)
        pli = np.full(S_pad, np.int32(2 ** 30), dtype=np.int32)
        pb = np.zeros(S_pad, dtype=np.int32)
        pkb = np.zeros(S_pad, dtype=np.int32)
        fr, fc = _onehot_coo(inputs.path_onehot_full)
        ir, ic = _onehot_coo(inputs.path_onehot_inner)
        pf_s = SparseOnehot((S_pad, V_pad), rows[fr], fc)
        pi_s = SparseOnehot((S_pad, V_pad), rows[ir], ic)
        pf = pf_s.to_dense() if dense_onehots else pf_s
        pi = pi_s.to_dense() if dense_onehots else pi_s
        plf[rows] = inputs.path_len_full
        pli[rows] = inputs.path_len_inner
        pkb[rows] = inputs.path_key_base
    else:
        apb = 0
        S_pad = _bucket(S, 64)
        fr, fc = _onehot_coo(inputs.path_onehot_full)
        ir, ic = _onehot_coo(inputs.path_onehot_inner)
        pf_s = SparseOnehot((S_pad, V_pad), fr, fc)
        pi_s = SparseOnehot((S_pad, V_pad), ir, ic)
        pf = pf_s.to_dense() if dense_onehots else pf_s
        pi = pi_s.to_dense() if dense_onehots else pi_s
        # padded paths: impossible length so they never match; bubble id
        # points at a sacrificial padded bubble row
        plf = np.pad(inputs.path_len_full, (0, S_pad - S),
                     constant_values=np.int32(2 ** 30))
        pli = np.pad(inputs.path_len_inner, (0, S_pad - S),
                     constant_values=np.int32(2 ** 30))
        pb = np.pad(inputs.path_bubble, (0, S_pad - S),
                    constant_values=np.int32(B_pad - 1) if B_pad > B else 0)
        pkb = np.pad(inputs.path_key_base, (0, S_pad - S))
    nodes = np.pad(nodes, ((0, 0), (0, L_pad - L)), constant_values=-1)
    if V_pad < 2 ** 15:
        # vocab indices fit int16: halves the dominant upload
        nodes = nodes.astype(np.int16)
    return ((pf, pi, plf, pli, pb, pkb, nodes, name_id, ident),
            (B_pad, N_pad, chunk, apb))


# HBM budget for the [3, B, N] key-table scan carry (the scatter-min
# double-buffers it, so peak ~2x this).  A 10k-bubble x 50k-read chain
# (BASELINE config 2) needs 6 GB un-blocked and OOMs a 16 GB chip; the
# bubble axis is embarrassingly parallel in containment, so oversized
# chains run in exact bubble blocks.
_KEY_TABLE_BUDGET = 1536 * 1024 * 1024

# above this many cells, fetch a key table as device-compacted COO
# instead of dense: the tables are ~0.01% non-NO_MATCH at config-2
# scale, and the dense 2 GB-per-table host fetch dominated the
# projection stage
# above this many cells a winner-table download goes through the
# device-side COO compaction.  Winner tables are sparse (one entry per
# (bubble, matching read)), so at 2M cells (8 MB dense) the COO transfer
# is already ~100x smaller; only small tables — where occupancy can be
# high and the dense download is a few MB anyway — fetch dense.
_SPARSE_FETCH_CELLS = 2 * 1024 * 1024


@functools.partial(jax.jit, static_argnames=("rows", "cols"))
def _count_keys(keys, *, rows: int, cols: int):
    return (keys[:rows, :cols] != NO_MATCH).sum()


@functools.partial(jax.jit, static_argnames=("rows", "cols", "k"))
def _compact_keys(keys, *, rows: int, cols: int, k: int):
    sl = keys[:rows, :cols]
    r, c = jnp.nonzero(sl != NO_MATCH, size=k, fill_value=0)
    return r.astype(jnp.int32), c.astype(jnp.int32), sl[r, c]


@functools.partial(jax.jit, static_argnames=("rows", "cols", "k"))
def _compact_keys_counted(keys, *, rows: int, cols: int, k: int):
    """Count + compact in ONE program: the separate count cost one more
    round trip per block; the static capacity k is a running
    guess (speculative — the caller refetches with a bigger k on the
    rare overflow)."""
    sl = keys[:rows, :cols]
    mask = sl != NO_MATCH
    cnt = mask.sum()
    r, c = jnp.nonzero(mask, size=k, fill_value=0)
    return r.astype(jnp.int32), c.astype(jnp.int32), sl[r, c], cnt


# chunk width of the hierarchical compaction (one VPU-friendly row per
# candidate rank)
_COMPACT_CHUNK = 512


def _compact_mask_scatter(flat_vals, mask, k: int):
    """Rank-based compaction of ``flat_vals[mask]`` into a packed
    [1 + 2k] int32 buffer [cnt, flat_pos(k), value(k)] — no sort, no
    scatter.

    The obvious lowerings are slow for 375M-cell blocks:
    jnp.nonzero(size=k) sorts, and a cumsum+scatter-by-rank serialises
    in the scatter.  This two-level search avoids both: (1) per-chunk
    match counts + a
    chunk-level cumsum give each rank its chunk via searchsorted;
    (2) a [k, chunk] gather + row cumsum locates the rank inside its
    chunk.  Everything is dense VPU work on [C] and [k, 512] arrays.
    Output order is flat/row-major, identical to nonzero's; ranks past
    capacity k produce garbage slots the caller never reads (it
    refetches with a bigger k on overflow, detected via cnt)."""
    n = flat_vals.size
    if n == 0:
        z = jnp.zeros(2 * k + 1, jnp.int32)
        return z
    if k > (1 << 19):
        # large capacities (multi-million-entry group fetches): the
        # [k, chunk] gather below would allocate k*512*4 bytes (a
        # 16 GB HBM request at k=8M), and k searchsorted queries cost
        # ~26 gather passes over the rank array (~4 s at k=4M).  One
        # sort-based nonzero over the n cells is cheaper here (~0.5 s
        # at 50M cells) and O(n + k) memory.
        cnt = mask.sum().astype(jnp.int32)
        (pos,) = jnp.nonzero(mask, size=k, fill_value=n - 1)
        pos = pos.astype(jnp.int32)
        val = flat_vals[pos]
        return jnp.concatenate([cnt[None], pos, val])
    C = -(-n // _COMPACT_CHUNK)
    m = jnp.pad(mask.astype(jnp.int32),
                (0, C * _COMPACT_CHUNK - n)).reshape(C, _COMPACT_CHUNK)
    cum = jnp.cumsum(m.sum(axis=1))
    cnt = cum[-1].astype(jnp.int32)
    ranks = jnp.arange(1, k + 1, dtype=jnp.int32)
    ci = jnp.minimum(jnp.searchsorted(cum, ranks), C - 1)
    prev = jnp.where(ci > 0, cum[jnp.maximum(ci - 1, 0)], 0)
    r_within = ranks - prev                      # 1-based within chunk
    rows = m[ci]                                 # [k, CHUNK]
    rowcum = jnp.cumsum(rows, axis=1)
    pos_in = jnp.argmax((rowcum == r_within[:, None]) & (rows > 0),
                        axis=1)
    pos = (ci * _COMPACT_CHUNK + pos_in).astype(jnp.int32)
    val = flat_vals[jnp.minimum(pos, n - 1)]
    return jnp.concatenate([cnt[None], pos, val])


@functools.partial(jax.jit, static_argnames=("rows", "cols", "k"))
def _compact_keys_packed(keys, *, rows: int, cols: int, k: int):
    """Count + compact into ONE buffer [1 + 2k] int32: [cnt, flat_pos,
    v] (r = pos // cols, c = pos % cols on host).  A (r, c, v, cnt)
    tuple fetch costs four device->host transfers per block (each
    np.asarray is its own round trip); the packed
    buffer makes the whole COO fetch a single transfer."""
    sl = keys[:rows, :cols]
    flat = sl.reshape(-1)
    return _compact_mask_scatter(flat, flat != NO_MATCH, k)


class SparseKeys:
    """COO view of a winner table: logically a [rows, cols] int32 array
    that is NO_MATCH everywhere except the matched entries (r, c) -> v.

    The matrix-native consumers (project/matrix.py) start by
    re-sparsifying dense tables (``np.nonzero(tbl != NO_MATCH)``), so
    for big blocked chains the pipeline carries this COO form end to
    end instead of materialising (and then rescanning) multi-GB dense
    tables on the host.  Entries are in device-compaction order
    (row-major: r ascending, c ascending within r)."""

    __slots__ = ("shape", "r", "c", "v")

    def __init__(self, shape, r, c, v):
        self.shape = shape
        self.r = r
        self.c = c
        self.v = v

    def coo(self):
        return self.r, self.c, self.v

    def row_slice(self, lo: int, hi: int) -> "SparseKeys":
        """Rows [lo, hi) re-based to 0 (contiguous sweep case).  Entries
        are row-major by construction, so the slice is two binary
        searches, not a full-length mask."""
        a = int(np.searchsorted(self.r, lo))
        b = int(np.searchsorted(self.r, hi))
        return SparseKeys((hi - lo, self.shape[1]),
                          self.r[a:b] - lo, self.c[a:b], self.v[a:b])

    def row_subset(self, rows: np.ndarray) -> "SparseKeys":
        """Rows re-indexed by their rank in the sorted ``rows`` list."""
        rows = np.asarray(rows, dtype=np.int64)
        if len(rows) == 0:
            z = np.zeros(0, dtype=np.int64)
            return SparseKeys((0, self.shape[1]), z, z,
                              np.zeros(0, dtype=self.v.dtype))
        idx = np.searchsorted(rows, self.r)
        idx_c = np.minimum(idx, len(rows) - 1)
        ok = (idx < len(rows)) & (rows[idx_c] == self.r)
        return SparseKeys((len(rows), self.shape[1]),
                          idx_c[ok], self.c[ok], self.v[ok])

    def to_dense(self) -> np.ndarray:
        out = np.full(self.shape, NO_MATCH, dtype=np.int32)
        out[self.r, self.c] = self.v
        return out


def table_coo(tbl):
    """(r, c, v) of the matched entries, row-major — for SparseKeys a
    view, for dense np tables one nonzero scan."""
    if isinstance(tbl, SparseKeys):
        return tbl.coo()
    r, c = np.nonzero(tbl != NO_MATCH)
    return r, c, tbl[r, c]


# running pow2 capacity guesses for the speculative count+compact fetch,
# keyed by the pow2 bucket of the table's cell count: one global guess
# thrashed between call sites (a 6M-entry group fetch pushed the guess
# to 16M, then every small per-chain fetch shipped a 128 MB buffer, or
# the group fetch re-overflowed after a small fetch shrank it)
_COO_GUESS = {}


def _guess_for(cells: int) -> int:
    return _COO_GUESS.get(max(cells, 1).bit_length(), 1 << 18)


def _update_guess_for(cells: int, cnt: int) -> None:
    # cap at 16M entries (~128 MB packed); floor keeps tiny tables cheap
    _COO_GUESS[max(cells, 1).bit_length()] = int(np.clip(
        1 << max(2 * cnt - 1, 1).bit_length(), 1 << 16, 1 << 24))


def _unpack_coo(arr: np.ndarray, k: int, cols: int):
    """Split a fetched [1 + 2k] packed buffer into (r, c, v) at its real
    count (caller has already handled overflow)."""
    cnt = int(arr[0])
    if cnt == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, np.zeros(0, dtype=np.int32)
    pos = arr[1:1 + cnt].astype(np.int64)
    v = arr[1 + k:1 + k + cnt]
    return pos // cols, pos % cols, v


# above this capacity, transfer the packed buffer in right-sized slices
# (count first, then exactly cnt positions + values) instead of the full
# k-padded buffer: a 4M-capacity speculative fetch ships 32 MB for
# ~12 MB of real entries
_SLICED_FETCH_K = 1 << 20


def _transfer_packed(packed, k: int, substage, counter: str):
    """Fetch a packed [1 + 2k] compaction buffer; returns (cnt, unpack)
    where unpack(cols) -> (r, c, v).  Large capacities transfer count +
    exact slices; small ones one speculative buffer."""
    if k < _SLICED_FETCH_K:
        arr = np.asarray(packed)
        substage.add(counter, 1.0)
        return int(arr[0]), lambda cols: _unpack_coo(arr, k, cols)
    cnt = int(np.asarray(packed[0]))
    substage.add(counter, 1.0)
    if cnt > k:
        return cnt, None            # caller refetches with a bigger k
    if cnt == 0:
        def unpack_empty(cols):
            z = np.zeros(0, dtype=np.int64)
            return z, z, np.zeros(0, dtype=np.int32)
        return 0, unpack_empty
    pos = np.asarray(packed[1:1 + cnt]).astype(np.int64)
    v = np.asarray(packed[1 + k:1 + k + cnt])
    substage.add(counter, 2.0)
    return cnt, lambda cols: (pos // cols, pos % cols, v)


def _fetch_coo(dev_keys, rows: int, cols: int):
    """Matched entries of a device table as host COO arrays, via ONE
    speculative count+compact program and ONE packed transfer.  The
    upstream kernel's execution time is attributed separately
    (projection.kernel_sync) from the compaction+transfer
    (projection.fetch); projection.fetch_calls counts round trips so the
    RTT share is computable from the warmup's device_rtt_est.  On the
    rare capacity overflow the fetch repeats with the exact pow2 size;
    the guess then tracks 2x the latest count."""
    from ahsoka_tpu.utils import substage

    if hasattr(dev_keys, "block_until_ready"):
        with substage.timed("projection.kernel_sync"):
            dev_keys.block_until_ready()
    with substage.timed("projection.fetch"):
        k = _guess_for(rows * cols)
        packed = _compact_keys_packed(dev_keys, rows=rows, cols=cols, k=k)
        cnt, unpack = _transfer_packed(packed, k, substage,
                                       "projection.fetch_calls")
        if cnt > k or unpack is None:
            k = 1 << max(cnt - 1, 1).bit_length()
            packed = _compact_keys_packed(dev_keys, rows=rows, cols=cols,
                                          k=k)
            cnt, unpack = _transfer_packed(packed, k, substage,
                                           "projection.fetch_calls")
        _update_guess_for(rows * cols, cnt)
        return unpack(cols)


def fetch_key_table(dev_keys, rows: int, cols: int) -> np.ndarray:
    """Device table -> np [rows, cols], via COO compaction on device when
    the dense fetch would be large.  Exact: every non-NO_MATCH entry is
    carried; the rest are NO_MATCH by construction."""
    from ahsoka_tpu.utils import substage

    if rows * cols < _SPARSE_FETCH_CELLS:
        with substage.timed("projection.fetch"):
            return np.asarray(dev_keys[:rows, :cols])
    r, c, v = _fetch_coo(dev_keys, rows, cols)
    with substage.timed("projection.host_scatter"):
        out = np.full((rows, cols), NO_MATCH, dtype=np.int32)
        out[r, c] = v
    return out


@functools.partial(jax.jit)
def _stack3_full(fk, pk, gk):
    return jnp.concatenate([fk, pk, gk], axis=0)


def _dispatch_coo3(fk, pk, gk, rows: int, cols: int):
    """Enqueue the fused count+compact for three tables; returns a
    handle for _resolve_coo3.  Dispatch-only: the device works on it
    while the host resolves the PREVIOUS block (the blocked projection
    loop double-buffers compute against fetch).

    The device programs operate on the tables' FULL padded shapes —
    already pow2-bucketed by the kernel padding — and the (rows, cols)
    real extents crop on host.  Slicing the real extents on device
    compiled a fresh stack+compaction program per distinct chain
    geometry: on ragged whole-genome inputs (config5) that meant
    hundreds of compiles.  Padded cells cannot match (padded
    paths are never contained, padded alignments never match), so the
    compaction output is identical."""
    R_pad, C_pad = fk.shape
    if 3 * R_pad * C_pad < _SPARSE_FETCH_CELLS:
        # small tables fetch dense, but still as ONE stacked transfer
        return ("dense", (_stack3_full(fk, pk, gk), R_pad, rows, cols))
    flat = _stack3_full(fk, pk, gk)
    k = _guess_for(3 * R_pad * C_pad)
    packed = _compact_keys_packed(flat, rows=3 * R_pad, cols=C_pad, k=k)
    return ("coo", (flat, packed, k, R_pad, C_pad, rows, cols))


def _resolve_coo3(handle):
    """Block on a _dispatch_coo3 handle; returns three tables (np dense
    for small, SparseKeys for large), cropped to the real extents.  One
    device->host transfer either way (the packed [cnt, r, c, v] buffer,
    or the stacked dense)."""
    from ahsoka_tpu.utils import substage

    kind, payload = handle
    if kind == "dense":
        stacked, R_pad, rows, cols = payload
        if hasattr(stacked, "block_until_ready"):
            with substage.timed("projection.kernel_sync"):
                stacked.block_until_ready()
        with substage.timed("projection.fetch"):
            host = np.asarray(stacked)
            substage.add("projection.fetch_calls", 1.0)
        return tuple(host[t * R_pad:t * R_pad + rows, :cols]
                     for t in range(3))
    flat, packed, k, R_pad, C_pad, rows, cols = payload
    with substage.timed("projection.kernel_sync"):
        flat.block_until_ready()
    with substage.timed("projection.fetch"):
        cnt, unpack = _transfer_packed(packed, k, substage,
                                       "projection.fetch_calls")
        if cnt > k or unpack is None:
            k = 1 << max(cnt - 1, 1).bit_length()
            packed = _compact_keys_packed(flat, rows=3 * R_pad,
                                          cols=C_pad, k=k)
            cnt, unpack = _transfer_packed(packed, k, substage,
                                           "projection.fetch_calls")
        _update_guess_for(3 * R_pad * C_pad, cnt)
        r, c, v = unpack(C_pad)
    result = []
    for t in range(3):
        keep = ((r >= t * R_pad) & (r < t * R_pad + rows) & (c < cols))
        result.append(SparseKeys((rows, cols), r[keep] - t * R_pad,
                                 c[keep], v[keep]))
    return tuple(result)


def fetch_key_tables3(fk, pk, gk, rows: int, cols: int):
    """Fetch all three winner tables through ONE count + ONE compaction
    (a third of the round trips of three fetch_key_table calls).  Large
    tables come
    back as SparseKeys — the matrix-native consumers take the COO form
    directly, so multi-GB dense tables are never materialised on host."""
    return _resolve_coo3(_dispatch_coo3(fk, pk, gk, rows, cols))


def containment_key_tables(inputs: ChainDeviceInputs,
                           config: PhasingConfig,
                           chunk: int = 1024
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run the device kernel with padding; returns numpy [B, N] tables."""
    from ahsoka_tpu.utils import substage

    with substage.timed("projection.pack"):
        arrays, statics = _padded_chain_arrays(inputs, chunk,
                                               dense_onehots=False)
    pf, pi, plf, pli, pb, pkb, nodes, name_id, ident = arrays
    B_pad, N_pad, chunk, apb = statics
    B = len(inputs.bubble_ids)
    n_real = len(inputs.names)

    def _densify():
        nonlocal pf, pi
        with substage.timed("projection.pack"):
            if isinstance(pf, SparseOnehot):
                pf = pf.to_dense()
            if isinstance(pi, SparseOnehot):
                pi = pi.to_dense()

    table_bytes = 3 * B_pad * N_pad * 4
    nblocks = max(1, -(-table_bytes // _KEY_TABLE_BUDGET))
    if nblocks == 1:
        _densify()
        with substage.timed("projection.device"):
            fk, pk, gk = _containment_keys_dispatch(
                inputs, pf, pi, plf, pli, pb, pkb, nodes, name_id,
                ident, config, B_pad, N_pad, chunk, apb)
        # fused fetch self-times (kernel_sync vs COO fetch)
        return fetch_key_tables3(fk, pk, gk, B, n_real)

    # bubble-blocked execution (exact: containment never crosses
    # bubbles); each block reuses one compiled kernel shape
    Bb = -(-B_pad // nblocks)
    log.info("projection: %d bubbles x %d reads in %d blocks of %d",
             B, n_real, nblocks, Bb)
    coo = [([], [], []) for _ in range(3)]      # per-table (r, c, v)
    shards = max(int(getattr(config, "data_shards", 1)), 1)
    dev = None
    if apb and not (shards > 1 and len(jax.devices()) >= shards):
        # uniform layout, unsharded: upload the full tables ONCE and
        # slice the bubble axis on device — per-block host slices
        # re-shipped ~150 MB of path tables per block.  The
        # path onehots are ~0.3% occupied ([20k, 50k] int8 = 1 GB dense
        # on config2): their COO coordinates ship directly (the dense
        # form is never built anywhere on this path — SparseOnehot from
        # construction) and scatter on device
        with substage.timed("projection.upload"):
            pf_r, pf_c = _onehot_coo(pf)
            pi_r, pi_c = _onehot_coo(pi)
            pf_dev = _scatter_onehot(pf_r.astype(np.int32),
                                     pf_c.astype(np.int32),
                                     shape=pf.shape)
            pi_dev = _scatter_onehot(pi_r.astype(np.int32),
                                     pi_c.astype(np.int32),
                                     shape=pi.shape)
            dev = [pf_dev, pi_dev] + [jax.device_put(a) for a in
                                      (plf, pli, pb, pkb, nodes,
                                       name_id, ident)]
    else:
        _densify()                     # host-slice blocked path
    pending = None                   # (handle, b0) double-buffer slot

    def _drain(p):
        handle, base = p
        blk = _resolve_coo3(handle)
        for t in range(3):
            r, c, v = table_coo(blk[t])
            coo[t][0].append(r + base)
            coo[t][1].append(c)
            coo[t][2].append(v)

    for b0 in range(0, B_pad, Bb):
        bb = min(Bb, B_pad - b0)
        if b0 >= B:
            break
        if dev is not None:
            with substage.timed("projection.device"):
                fk, pk, gk = _containment_keys_block(
                    *dev, np.float32(config.partial_identity_gate),
                    jnp.int32(b0), num_bubbles=bb, num_names=N_pad,
                    chunk=chunk, alleles_per_bubble=apb,
                    block_rows=bb * apb)
        else:
            if apb:
                sl = slice(b0 * apb, (b0 + bb) * apb)
            else:
                lo, hi = np.searchsorted(pb, [b0, b0 + bb])
                sl = slice(int(lo), int(hi))
            with substage.timed("projection.device"):
                fk, pk, gk = _containment_keys_dispatch(
                    inputs, pf[sl], pi[sl], plf[sl], pli[sl],
                    (pb[sl] - b0).astype(pb.dtype), pkb[sl], nodes,
                    name_id, ident, config, bb, N_pad, chunk, apb)
        n_rows = min(bb, B - b0)
        # enqueue this block's compaction, THEN resolve the previous
        # block: the host fetch overlaps the device's work on this one
        # (the dispatch timer captures trace+compile time, which blocks
        # the host on first-shape calls)
        with substage.timed("projection.dispatch"):
            handle = _dispatch_coo3(fk, pk, gk, n_rows, n_real)
        del fk, pk, gk
        if pending is not None:
            _drain(pending)
        pending = (handle, b0)
    if pending is not None:
        _drain(pending)
    # whole-table COO (blocks ascending + per-block row-major order =
    # global row-major order); the matrix-native consumers take this
    # directly — no multi-GB dense host tables
    return tuple(
        SparseKeys((B, n_real),
                   np.concatenate(rs) if rs else np.zeros(0, np.int64),
                   np.concatenate(cs) if cs else np.zeros(0, np.int64),
                   np.concatenate(vs) if vs else np.zeros(0, np.int32))
        for rs, cs, vs in coo)


@functools.partial(jax.jit, static_argnames=("shape",))
def _scatter_onehot(r, c, *, shape):
    """Device-side onehot build from COO coordinates (values all 1)."""
    return jnp.zeros(shape, jnp.int8).at[r, c].set(1)


@functools.partial(jax.jit,
                   static_argnames=("num_bubbles", "num_names", "chunk",
                                    "alleles_per_bubble", "block_rows"))
def _containment_keys_block(pf, pi, plf, pli, pb, pkb, nodes, name_id,
                            ident, gate, b0, *, num_bubbles: int,
                            num_names: int, chunk: int,
                            alleles_per_bubble: int, block_rows: int):
    """Bubble-block slice of the containment kernel over device-resident
    full tables (uniform apb layout: row r = bubble * apb + rank, so a
    bubble block is a contiguous row slice at offset b0 * apb)."""
    r0 = b0 * alleles_per_bubble

    def rows2(a):
        return jax.lax.dynamic_slice(a, (r0, 0), (block_rows, a.shape[1]))

    def rows1(a):
        return jax.lax.dynamic_slice(a, (r0,), (block_rows,))

    return containment_keys_core(
        rows2(pf), rows2(pi), rows1(plf), rows1(pli), rows1(pb),
        rows1(pkb), nodes, name_id, ident, gate,
        num_bubbles=num_bubbles, num_names=num_names, chunk=chunk,
        alleles_per_bubble=alleles_per_bubble)


def _containment_keys_dispatch(inputs, pf, pi, plf, pli, pb, pkb, nodes,
                               name_id, ident, config, B_pad: int,
                               N_pad: int, chunk: int, apb: int):
    """One kernel invocation (possibly data-sharded over the mesh)."""
    A_pad = nodes.shape[0]
    shards = max(int(getattr(config, "data_shards", 1)), 1)
    if shards > 1 and len(jax.devices()) >= shards:
        # data-parallel projection: alignments shard over the mesh, the
        # per-shard winner tables merge with a min collective
        from ahsoka_tpu.dist.mesh import make_mesh
        from ahsoka_tpu.dist.step import sharded_containment_keys

        A_shard = _round_up(A_pad, shards * chunk)
        extra = A_shard - nodes.shape[0]
        if extra:
            nodes = np.pad(nodes, ((0, extra), (0, 0)),
                           constant_values=-1)
            name_id = np.pad(name_id, (0, extra),
                             constant_values=len(inputs.names))
            ident = np.pad(ident, (0, extra))
        mesh = make_mesh(data=shards, chain=1,
                         devices=jax.devices()[:shards])
        return sharded_containment_keys(
            mesh, pf, pi, plf, pli, pb, pkb, nodes, name_id, ident,
            np.float32(config.partial_identity_gate),
            num_bubbles=B_pad, num_names=N_pad, chunk=chunk,
            alleles_per_bubble=apb)
    return _containment_keys(
        pf, pi, plf, pli, pb, pkb, nodes, name_id, ident,
        np.float32(config.partial_identity_gate),
        num_bubbles=B_pad, num_names=N_pad, chunk=chunk,
        alleles_per_bubble=apb)


@functools.partial(jax.jit, static_argnames=("num_bubbles", "num_names",
                                             "chunk", "alleles_per_bubble"))
def _containment_keys_vmapped(pf, pi, plf, pli, pb, pkb, nodes, name_id,
                              ident, gate_mask_value, *, num_bubbles: int,
                              num_names: int, chunk: int,
                              alleles_per_bubble: int):
    """Leading chain axis on every array argument; one device program for
    a whole group of same-shape chains."""
    def one(pf, pi, plf, pli, pb, pkb, nodes, name_id, ident):
        return containment_keys_core(
            pf, pi, plf, pli, pb, pkb, nodes, name_id, ident,
            gate_mask_value, num_bubbles=num_bubbles, num_names=num_names,
            chunk=chunk, alleles_per_bubble=alleles_per_bubble)
    return jax.vmap(one)(pf, pi, plf, pli, pb, pkb, nodes, name_id, ident)


# transfer budget per batched call (bytes, upload+download): batches want
# to be large (one round trip each) but bounded (memory + latency of a
# single huge transfer)
_BATCH_TRANSFER_BUDGET = 96 * 1024 * 1024


def containment_key_tables_many(inputs_list: Sequence[ChainDeviceInputs],
                                config: PhasingConfig, chunk: int = 1024
                                ) -> List[Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]]:
    """Projection winner tables for MANY chains in few device calls.

    Chains are padded into bucketed shapes, grouped by (shape, statics)
    signature, and each group runs as ONE vmapped kernel call (split only
    by a transfer-size budget), amortizing the per-call round trip over
    many chains.
    Results are identical to per-chain containment_key_tables (same core
    kernel; parity-tested)."""
    from ahsoka_tpu.utils import substage

    shards = max(int(getattr(config, "data_shards", 1)), 1)
    if shards > 1 and len(jax.devices()) >= shards:
        # sharded projection keeps the per-chain path (its collective
        # merge already owns the device axis)
        return [containment_key_tables(i, config, chunk)
                for i in inputs_list]
    with substage.timed("projection.pack"):
        padded = [_padded_chain_arrays(i, chunk) for i in inputs_list]
    groups: Dict[tuple, List[int]] = {}
    for idx, (arrays, statics) in enumerate(padded):
        sig = (statics, tuple((a.shape, a.dtype.str) for a in arrays))
        groups.setdefault(sig, []).append(idx)

    results: List = [None] * len(inputs_list)
    # group-fetch pipeline: each batch's fused COO fetch is DISPATCHED
    # right after its kernel, then RESOLVED while the next batch's
    # kernel runs on device (the same double-buffering the blocked
    # single-chain path uses across bubble blocks) — round 4 charged
    # 6.2 s of config4's projection to fetches serialized against
    # compute
    pending = None          # (batch, handle, stride)

    def _drain_group(p):
        batch, handle, stride = p
        tabs = _resolve_coo3(handle)
        for j, i in enumerate(batch):
            B = len(inputs_list[i].bubble_ids)
            n = len(inputs_list[i].names)
            r0 = j * stride
            chain_tabs = []
            for t in tabs:
                if isinstance(t, SparseKeys):
                    sk = t.row_slice(r0, r0 + B)
                    # drop padded-read columns (>= the chain's real
                    # reads); real entries never land there
                    ok = sk.c < n
                    chain_tabs.append(
                        SparseKeys((B, n), sk.r[ok], sk.c[ok],
                                   sk.v[ok]))
                else:
                    chain_tabs.append(t[r0:r0 + B, :n])
            results[i] = tuple(chain_tabs)

    for (statics, shape_sig), idxs in groups.items():
        B_pad, N_pad, g_chunk, apb = statics
        # budget groups by UPLOAD bytes only: the winner-table download
        # is COO-compacted (tiny) above _SPARSE_FETCH_CELLS and a few
        # MB below it, so counting the dense output capped groups ~5x
        # smaller than the link can handle (more round trips)
        per_chain_bytes = sum(int(np.prod(s)) * np.dtype(d).itemsize
                              for s, d in shape_sig)
        cap = max(1, _BATCH_TRANSFER_BUDGET // max(per_chain_bytes, 1))
        # split big groups into a few batches so each batch's fused
        # fetch overlaps the NEXT batch's kernel (one 1000-chain batch
        # serialises kernel exec against its own fetch)
        cap = min(cap, max(64, -(-len(idxs) // 4)))
        if 3 * B_pad * N_pad * 4 > _KEY_TABLE_BUDGET:
            # oversized key tables: the per-chain path runs these in
            # exact bubble blocks instead of one HBM-breaking carry
            for i in idxs:
                results[i] = containment_key_tables(inputs_list[i],
                                                    config, g_chunk)
            continue
        for lo in range(0, len(idxs), cap):
            batch = idxs[lo:lo + cap]
            if len(batch) == 1:
                i = batch[0]
                arrays, _ = padded[i]
                with substage.timed("projection.device"):
                    fk, pk, gk = _containment_keys(
                        *arrays,
                        np.float32(config.partial_identity_gate),
                        num_bubbles=B_pad, num_names=N_pad,
                        chunk=g_chunk, alleles_per_bubble=apb)
                B = len(inputs_list[i].bubble_ids)
                n = len(inputs_list[i].names)
                with substage.timed("projection.dispatch"):
                    handle = _dispatch_coo3(fk, pk, gk, B, n)
                if pending is not None:
                    _drain_group(pending)
                pending = ([i], handle, B_pad)
                continue
            # bucket the batch's chain count (repeat the last chain):
            # the vmapped kernel compiles per leading dim, and ragged
            # whole-genome inputs otherwise produce a distinct group
            # size — and a fresh compile — per (signature, tail)
            C = len(batch)
            C_b = _bucket(C, minimum=8)
            with substage.timed("projection.pack"):
                stacked = [np.stack([padded[i][0][k] for i in batch]
                                    + [padded[batch[-1]][0][k]]
                                    * (C_b - C))
                           for k in range(9)]
            with substage.timed("projection.device"):
                fk, pk, gk = _containment_keys_vmapped(
                    *stacked, np.float32(config.partial_identity_gate),
                    num_bubbles=B_pad, num_names=N_pad, chunk=g_chunk,
                    alleles_per_bubble=apb)
            # ONE fused fetch for all three tables of the whole group
            # (packed COO when large, one stacked dense transfer when
            # small), at the FULL padded shapes (compile-stable); the
            # real row extent crops the repeated pad chains.  Large
            # groups stay COO end to end: each chain's SparseKeys view
            # feeds the matrix-native consumers directly.
            flats = [t.reshape(C_b * B_pad, N_pad)
                     for t in (fk, pk, gk)]
            with substage.timed("projection.dispatch"):
                handle = _dispatch_coo3(*flats, C * B_pad, N_pad)
            if pending is not None:
                _drain_group(pending)
            pending = (batch, handle, B_pad)
    if pending is not None:
        _drain_group(pending)
    return results


def _decode(key: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    allele = key >> AL_BITS
    al = key & MAX_ALN
    return allele, al


def assemble_readsets(inputs: ChainDeviceInputs,
                      full_keys: np.ndarray,
                      part_keys: np.ndarray,
                      gate_keys: np.ndarray,
                      config: PhasingConfig) -> ChainReadsets:
    """Rebuild the reference-ordered readsets from the winner tables."""
    # the debug/oracle path works on dense tables; big blocked chains
    # arrive as SparseKeys (debug dumps are off at that scale anyway)
    if isinstance(full_keys, SparseKeys):
        full_keys = full_keys.to_dense()
    if isinstance(part_keys, SparseKeys):
        part_keys = part_keys.to_dense()
    if isinstance(gate_keys, SparseKeys):
        gate_keys = gate_keys.to_dense()
    bubble_ids = inputs.bubble_ids
    B, N = full_keys.shape
    identity = inputs.aln_identity

    # ---- full pass ----
    full_match = full_keys != NO_MATCH
    full = ReadSet()
    if N:
        # read creation order: first (bubble stdmap-rank, allele, al) match
        if config.compat_std_ordering:
            from ahsoka_tpu.compat import native_iteration_order
            order = native_iteration_order([int(b) for b in bubble_ids])
            rank_of = {b: r for r, b in enumerate(order)}
            ranks = np.asarray([rank_of[int(b)] for b in bubble_ids],
                               dtype=np.int64)
        else:
            ranks = np.arange(B, dtype=np.int64)
        # per name: winning bubble by rank among matches
        order_key = np.where(
            full_match,
            ranks[:, None] * np.int64(1 << 31) + full_keys.astype(np.int64),
            np.int64(1 << 62))
        creation_key = order_key.min(axis=0)
        name_order = np.argsort(creation_key, kind="stable")
        allele_tab, al_tab = _decode(full_keys)
        for n in name_order:
            if not full_match[:, n].any():
                continue
            win_b = int(np.argmin(order_key[:, n]))
            _, win_al = int(allele_tab[win_b, n]), int(al_tab[win_b, n])
            read = Read(inputs.names[n],
                        int(identity[win_al] * config.mapq_scale))
            bs = np.nonzero(full_match[:, n])[0]
            read.positions = [int(bubble_ids[b]) for b in bs]
            read.alleles = [int(allele_tab[b, n]) for b in bs]
            full.add(read)
    full_filtered = _filter(full, config)

    # ---- partial pass ----
    sweep = partial_position_sweep(full, full_filtered)
    bubble_index = {int(b): i for i, b in enumerate(bubble_ids)}
    sweep_dense = [bubble_index[p] for p in sweep if p in bubble_index]
    partial = ReadSet()
    if sweep_dense and N:
        sd = np.asarray(sweep_dense)
        pm = part_keys[sd] != NO_MATCH          # [Bs, N]
        gm = gate_keys[sd] != NO_MATCH
        p_allele, p_al = _decode(part_keys[sd])
        g_allele, _ = _decode(gate_keys[sd])
        any_match = pm.any(axis=0)
        first_row = np.where(any_match, pm.argmax(axis=0), -1)
        # creation order: ascending position, then packed key
        creation = np.where(
            any_match,
            first_row.astype(np.int64) * (1 << 31)
            + part_keys[sd][np.maximum(first_row, 0),
                            np.arange(N)].astype(np.int64),
            np.int64(1 << 62))
        for n in np.argsort(creation, kind="stable"):
            if not any_match[n]:
                continue
            r0 = int(first_row[n])
            win_al = int(p_al[r0, n])
            read = Read(inputs.names[n],
                        int(identity[win_al] * config.mapq_scale))
            positions = [int(bubble_ids[sd[r0]])]
            alleles = [int(p_allele[r0, n])]
            for r in range(r0 + 1, len(sd)):
                if gm[r, n]:
                    positions.append(int(bubble_ids[sd[r]]))
                    alleles.append(int(g_allele[r, n]))
            read.positions = positions
            read.alleles = alleles
            partial.add(read)
    partial_filtered = _filter(partial, config)
    partial_filtered.sort_by_first_position()
    return ChainReadsets(full=full, full_filtered=full_filtered,
                         partial=partial,
                         partial_filtered=partial_filtered,
                         projected_positions=sweep)


def build_chain_readsets_device(bubble_paths: Dict[int, List[List[int]]],
                                alignments: Sequence[Alignment],
                                config: PhasingConfig) -> ChainReadsets:
    inputs = prepare_chain_inputs(bubble_paths, alignments)
    if inputs.num_alignments == 0 or inputs.num_paths == 0:
        from ahsoka_tpu.project.readset import build_chain_readsets
        return build_chain_readsets(bubble_paths, alignments, config)
    full_keys, part_keys, gate_keys = containment_key_tables(inputs, config)
    return assemble_readsets(inputs, full_keys, part_keys, gate_keys, config)
