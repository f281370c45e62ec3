"""Logging for the ``magiattention_tpu_torch`` logger tree.

The JAX package's ``telemetry/logger.py``: ``MAGI_ATTENTION_LOG_LEVEL``
(``env.log_level()``) sets the package logger's level, and a set flag also
attaches one formatted stderr handler. Unknown level names degrade to
WARNING. With the flag unset the logger is left as it is, so an embedder's
own logging configuration keeps control. The port configures the tree the
first time :func:`get_logger` is called (the package's import stays light);
attaching the handler is idempotent.
"""

from __future__ import annotations

import logging

LOGGER_NAME = "magiattention_tpu_torch"

_configured = False


def resolve_level(name: str | None = None) -> int:
    """Level name -> ``logging`` level, through ``env.log_level()`` by
    default; an unknown name gives WARNING."""
    from .. import env

    if name is None:
        name = env.log_level()
    level = getattr(logging, name.strip().upper(), None)
    return level if isinstance(level, int) else logging.WARNING


def configure_logging(force_handler: bool = False) -> logging.Logger:
    """Configure and return the package logger: a set
    ``MAGI_ATTENTION_LOG_LEVEL`` sets its level and attaches a formatted
    stderr handler (once); unset, the logger is returned as it is."""
    from .. import env

    logger = logging.getLogger(LOGGER_NAME)
    explicit = env.log_level_explicit()
    if explicit:
        logger.setLevel(resolve_level())
    if (explicit or force_handler) and not any(
        getattr(h, "_magi_handler", False) for h in logger.handlers
    ):
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("[%(asctime)s][%(name)s][%(levelname)s] %(message)s")
        )
        handler._magi_handler = True  # idempotence tag
        logger.addHandler(handler)
        logger.propagate = False
    return logger


def get_logger(child: str | None = None) -> logging.Logger:
    """The package logger, or a dotted child (``get_logger("resilience")``
    -> ``magiattention_tpu_torch.resilience``)."""
    global _configured
    if not _configured:
        configure_logging()
        _configured = True
    name = LOGGER_NAME if not child else f"{LOGGER_NAME}.{child}"
    return logging.getLogger(name)
