"""kmerax_torch — the PyTorch/CUDA port of kmerax for one NVIDIA H100.

The JAX package `kmerax/` is the reference: this package mirrors its layout
and names and produces the same bytes (DESIGN.md §13) for the main path
count -> correct -> assemble. It imports torch and never jax or kmerax.

  core/      2-bit codec, k-mer extraction, hashing (torch, int64 words)
  io/        FASTQ/FASTA streaming, batching (numpy)
  spectrum/  counting Bloom (kernels K1, K2), exact host spectrum
  ops/       error correction (kernel K3)
  graph/     unitig assembly, host path
  pipeline/  count / correct / run stages
  cli        `python -m kmerax_torch.cli pipeline ...`
  csrc/      the CUDA kernels (sm_90a), built at first use
"""

__version__ = "0.1.0"

from kmerax_torch.config import KmeraxConfig
