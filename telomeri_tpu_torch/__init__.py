"""telomeri-tpu on PyTorch and CUDA: the scaffolder for NVIDIA Hopper GPUs
(H100), on one device or sharded over several, beside the JAX package
`telomeri_tpu`, which stays the reference it is tested against.

The layout mirrors the reference, module for module:

  io/geometry.py      build_edges + device rescoring (scores from this package)
  io/artifacts.py     graph / walks artifacts, in the reference's file format
  graph/tensorize.py  EdgeSoA -> padded CSR (numpy)
  walk/engine.py      walk tables on the device, Threefry draw table, MC / greedy
                      scans (row fetch as a parameter), sectioned and chunked dispatch
  walk/rescue.py      rescue rounds of dense MC re-walks
  walk/oracle.py      the scalar walk oracle on this package's Threefry stream
  consensus/grouping.py  path signatures, grouping and representative selection
  consensus/evidence.py, coherence.py  the reference's host gates, with this
                      package's fetch of records left on a mesh's ranks
  dist/mesh.py        torch.distributed walk sharding, one process per device
  dist/rowshard.py    row-sharded walk tables for graphs beyond one device
  kernels/            hand-written CUDA kernels (csrc/*.cu) and their plain
                      torch versions
  utils/profiling.py  --trace: torch.profiler around the walk stage
  pipeline.py         build_graph + run_pipeline
  cli/main.py         `telomeri-tpu-torch scaffold ... --device cuda [--mesh N]`
  interop.py          carry the reference's packed tables across

Host-only modules with no JAX in their import chain (config, io.fasta, io.paf,
native, walk.plan, scaffold, utils, sim, and the numpy halves of io.artifacts,
walk.oracle and consensus.evidence / coherence) are imported from
`telomeri_tpu`, never copied. This package never imports jax.
"""

__version__ = "0.1.0"
