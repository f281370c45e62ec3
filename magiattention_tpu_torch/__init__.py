"""MagiAttention on PyTorch and CUDA: the Hopper (sm_90a) port.

A second package beside ``magiattention_tpu`` that mirrors its layout one
subpackage at a time, so every module here has a twin at the same
relative path there. It imports ``torch`` and never ``jax`` or the JAX
package: what it needs from there it keeps as its own copy.

Layering of the serving, training, sparse-grid, shared-prefix and
context-parallel slices:

- ``common/``  : the mask-type int ABI, dense-mask semantics and areas, the
  range algebra and rectangles, the cp spec's normaliser (``axes``) and the
  planner's protocols
- ``meta/``    : the dispatch containers, the dispatch meta, the dispatch
  and overlap solvers, and the plan fingerprints of bucketed plan reuse
- ``comm/``    : GroupCast / GroupReduce and variable-size collectives over
  ``torch.distributed``
- ``parallel/``: dispatch / undispatch and the distributed flex-attention
  plan and runtime (``dist_attn_local``)
- ``api/``     : mask and padding helpers, and the keyed cp runtime
  (``magi_attn_flex_key`` -> ``dispatch`` -> ``calc_attn`` -> ``undispatch``)
- ``ops/``     : host kernel tables, LSE correction, flex attention forward
  and backward under ``torch.autograd`` on two grids (the row-major
  ``flex_fwd``, ``flex_fwd_hb``, ``flex_dq``, ``flex_dkv`` and the sparse-grid
  ``flex_fwd_sparse``, ``flex_fwd_sparse_hb``, ``flex_dq_sparse``,
  ``flex_dkv_sparse`` Hopper kernels + their plain PyTorch versions), and
  ``auto_kernel_config``, which picks the grid and the head_block; the
  block-sparse, index and sparse-load entry points on the same kernels
- ``tuning/``  : the mask area and density behind the grid choice
- ``csrc/``    : the hand-written CUDA kernels, built with nvcc on first use,
  and the host planner's native entry emitter, built with g++
- ``extensions/``: attention with sinks, and DSA-style top-k attention
- ``serving/`` : paged KV cache, split-KV decode (the ``paged_decode``
  kernel + its plain version), shared prefixes (copy-on-write pages and
  cascade decode), the continuous-batching engine
- ``models/``  : the Llama decoder (cp=1 and under cp) and its train step
- ``testing/`` : the fp64 dense oracle and its online twin, precision
  checks, the flag generator, the dispatch oracle, the reference mask
  workloads, and the rank spawner of multi-rank runs
- ``telemetry/``: the numerics oracle (error budgets, divergence reports)
- ``utils/``   : sample packing (documents -> fixed-capacity streams)
- ``convert``  : cache, plan and Llama parameters to and from numpy arrays

A function that takes tensors runs where its tensors are: CUDA tensors
launch the Hopper kernel (or raise), CPU tensors take the plain version.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy subpackage access, as in the JAX package: importing the package
    # loads nothing heavier than this file
    import importlib

    if name in (
        "api", "comm", "common", "config", "convert", "csrc", "env", "extensions", "meta",
        "models", "ops",
        "parallel", "serving", "telemetry", "testing", "tuning", "utils",
    ):
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)


__all__ = [
    "api",
    "comm",
    "common",
    "config",
    "convert",
    "csrc",
    "env",
    "extensions",
    "meta",
    "models",
    "ops",
    "parallel",
    "serving",
    "telemetry",
    "testing",
    "tuning",
    "utils",
    "__version__",
]
