"""telomeri-tpu on PyTorch and CUDA: the scaffolder for NVIDIA Hopper GPUs
(H100), on one device or sharded over several, beside the JAX package
`telomeri_tpu`, which stays the reference it is tested against.

The layout mirrors the reference, module for module, under the same file and
public names, so that a reader finds the counterpart:

  config.py, sim.py   ScaffoldConfig; the dataset simulator
  io/fasta.py, io/paf.py, native/   host ingest, with the optional C++ parsers
  io/geometry.py      overlap geometry, build_edges + device rescoring
  io/artifacts.py     graph / walks artifacts, in the reference's file format
  graph/tensorize.py  EdgeSoA -> padded CSR (numpy)
  walk/plan.py        the walk plan
  walk/engine.py      walk tables on the device, Threefry draw table, MC / greedy
                      scans (row fetch as a parameter), sectioned and chunked dispatch
  walk/rescue.py      rescue rounds of dense MC re-walks
  walk/oracle.py      the scalar walk oracle on this package's Threefry stream
  consensus/grouping.py  path signatures, grouping and representative selection
  consensus/evidence.py, coherence.py  the host gates, with this package's
                      fetch of records left on a mesh's ranks
  scaffold/           conflict resolution, stitching, AGP, junction polish
  dist/mesh.py        torch.distributed walk sharding, one process per device
  dist/rowshard.py    row-sharded walk tables for graphs beyond one device
  kernels/            hand-written CUDA kernels (csrc/*.cu) and their plain
                      torch versions
  utils/              logging, shapes, stats, align, validate, watchdog, and
                      profiling.py (--trace: torch.profiler around the whole
                      run; the program's named spans and counters)
  pipeline.py         build_graph + run_pipeline
  cli/main.py         `telomeri-tpu-torch scaffold ... --device cuda [--mesh N]`
  interop.py          carry the reference's tables and dataclasses across

The package stands alone: it imports torch and numpy, never jax, and nothing
of `telomeri_tpu`, not even a module there that does not import jax. Every host
module it uses is its own copy, verbatim in behaviour (same functions, same
numpy arithmetic, same orders of iteration), held against the reference by the
tests, which alone import both packages.
"""

__version__ = "0.1.0"
