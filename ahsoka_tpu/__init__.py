"""ahsoka_tpu — an accelerator-native haplotype-assembly engine.

A brand-new framework (JAX/XLA/pjit + Pallas, with native C++ host components)
that phases diploid and polyploid genomes from a GFA assembly graph plus GAF
long-read alignments.  Capability parity target: rebeccaserramari/Ahsoka
(see SURVEY.md for the reference's component inventory).

Pipeline (reference: /root/reference/src/polyassembly.cpp:22-176):

    GFA graph ──> bubble/chain detection ──> allele-path enumeration
                                                    │
    GAF reads ──> per-chain projection (read × bubble allele matrix) [device]
                                                    │
                  pairwise read scoring (matmuls)                    [device]
                                                    │
                  cluster editing (host heuristic / native C++)
                                                    │
                  haplotype-threading DP (min-plus scan / GPU kernel) [device]
                                                    │
                  haplotype emission (oriented node walks)

The graph/bubble index is replicated per host; GAF read batches are sharded
data-parallel over a `jax.sharding.Mesh`, with per-shard partials merged via
XLA collectives (see ahsoka_tpu.dist).
"""

__version__ = "0.1.0"

from ahsoka_tpu.config import PhasingConfig  # noqa: F401
