"""MagiAttention on PyTorch and CUDA: the Hopper (sm_90a) port.

A second package beside ``magiattention_tpu`` that mirrors its layout one
subpackage at a time, so every module here has a twin at the same
relative path there. It imports ``torch`` and never ``jax`` or the JAX
package: what it needs from there it keeps as its own copy.

Layering of the serving, single-device training, sparse-grid and
shared-prefix slices:

- ``common/``  : the mask-type int ABI, dense-mask semantics, range algebra
- ``api/``     : mask and padding helpers
- ``ops/``     : host kernel tables, LSE correction, flex attention forward
  and backward under ``torch.autograd`` on two grids (the row-major
  ``flex_fwd``, ``flex_fwd_hb``, ``flex_dq``, ``flex_dkv`` and the sparse-grid
  ``flex_fwd_sparse``, ``flex_fwd_sparse_hb``, ``flex_dq_sparse``,
  ``flex_dkv_sparse`` Hopper kernels + their plain PyTorch versions), and
  ``auto_kernel_config``, which picks the grid and the head_block
- ``tuning/``  : the mask area and density behind the grid choice
- ``csrc/``    : the hand-written CUDA kernels, built with nvcc on first use
- ``serving/`` : paged KV cache, split-KV decode (the ``paged_decode``
  kernel + its plain version), shared prefixes (copy-on-write pages and
  cascade decode), the continuous-batching engine
- ``models/``  : the single-device Llama decoder and its train step
- ``testing/`` : the fp64 dense oracle and the reference mask workloads
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
        "api", "common", "convert", "csrc", "env", "models", "ops", "serving", "testing",
        "tuning",
    ):
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)


__all__ = [
    "api",
    "common",
    "convert",
    "csrc",
    "env",
    "models",
    "ops",
    "serving",
    "testing",
    "tuning",
    "__version__",
]
