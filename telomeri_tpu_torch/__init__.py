"""telomeri-tpu on PyTorch and CUDA: the scaffolder's single-device path for an
NVIDIA Hopper GPU (H100), beside the JAX package `telomeri_tpu`, which stays the
reference it is tested against.

The layout mirrors the reference, module for module:

  io/geometry.py      build_edges + device rescoring (scores from this package)
  graph/tensorize.py  EdgeSoA -> padded CSR (numpy)
  walk/engine.py      walk tables on the device, Threefry draw table, MC / greedy
                      scans, sectioned and chunked dispatch
  walk/rescue.py      one rescue round of dense MC re-walks
  consensus/grouping.py  path signatures, grouping and representative selection
  kernels/            hand-written CUDA kernels (csrc/*.cu) and their plain
                      torch versions
  pipeline.py         build_graph + run_pipeline (single device)
  cli/main.py         `telomeri-tpu-torch scaffold ... --device cuda`
  interop.py          carry the reference's packed tables across

Host-only modules with no JAX in their import chain (config, io.fasta, io.paf,
native, walk.plan, consensus.evidence / coherence, scaffold, utils, sim) are
imported from `telomeri_tpu`, never copied. This package never imports jax.
"""

__version__ = "0.1.0"
