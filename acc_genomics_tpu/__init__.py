"""acc_genomics_tpu — accelerator genomics kernel engine, run on NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
falcon-computing/acc_genomics (an FPGA genomics kernel library):

  * PairHMM  — forward-algorithm read/haplotype likelihoods (GATK HaplotypeCaller)
  * SMEM     — super-maximal exact matches over an FM-index (BWA-MEM seeding)
  * SW       — full Smith-Waterman with backtrack -> CIGAR (GATK HC realignment)
  * EXTEND   — banded Smith-Waterman seed extension (BWA-MEM mem_chain2aln)

Layering (a redesign, not a port):
  ops/       batched compute kernels: NumPy oracles (golden), pure-XLA impls,
             and a Pallas (Triton) GPU kernel for PairHMM
  engine/    single-device engine: length bucketing, packing, jit caching,
             cost-model dispatch, fp64 underflow recompute
  parallel/  device-mesh scaling: shard_map data/sequence parallel dispatch
  io/        reference-format corpora parsers and synthetic generators
  native/    C++ host runtime (index construction, CIGAR walk, packing)
"""

__version__ = "0.1.0"

from acc_genomics_tpu.config import (  # noqa: F401
    PairHMMConfig,
    SmemConfig,
    SWConfig,
    ExtendConfig,
    EngineConfig,
)
