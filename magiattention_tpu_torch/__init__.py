"""MagiAttention on PyTorch and CUDA: the Hopper (sm_90a) port.

A second package beside ``magiattention_tpu`` that mirrors its layout one
subpackage at a time, so every module here has a twin at the same
relative path there. It imports ``torch`` and never ``jax`` or the JAX
package: what it needs from there it keeps as its own copy.

Layering of the serving and single-device training slices:

- ``common/``  : the mask-type int ABI, dense-mask semantics, range algebra
- ``api/``     : mask and padding helpers
- ``ops/``     : host kernel tables, LSE correction, flex attention forward
  and backward under ``torch.autograd`` (the ``flex_fwd``, ``flex_dq`` and
  ``flex_dkv`` Hopper kernels + their plain PyTorch versions)
- ``csrc/``    : the hand-written CUDA kernels, built with nvcc on first use
- ``serving/`` : paged KV cache, split-KV decode (the ``paged_decode``
  kernel + its plain version), the continuous-batching engine
- ``models/``  : the single-device Llama decoder and its train step
- ``testing/`` : the fp64 dense oracle
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
    "__version__",
]
