"""Pin the JAX package's kernel backend in a test that runs both packages.

Both packages read ``MAGI_ATTENTION_KERNEL_BACKEND``, under different names
(the JAX package's ``pallas|jnp|jnp_online``, the port's
``cuda|torch|torch_online``), and the port raises on a JAX name. So a test
that runs the JAX twin on its dense jnp path pins it through the JAX
package's ``env.kernel_backend`` (every JAX reader calls it) and leaves the
variable, which the port also reads, alone."""

from magiattention_tpu import env as jax_env


def jax_backend(mp, backend: str = "jnp") -> None:
    """Run the JAX package on ``backend`` for the rest of ``mp``'s scope
    (a pytest ``MonkeyPatch``)."""
    mp.setattr(jax_env, "kernel_backend", lambda: backend)
