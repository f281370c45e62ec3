"""AttnForwardMeta: auxiliary forward outputs of the keyed API."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class AttnForwardMeta:
    """The log-sum-exp per (token, head) and optionally the per-head max
    logit (Muon QK-Clip), as the JAX package's ``AttnForwardMeta``."""

    lse: Optional[torch.Tensor] = None  # [tokens, heads_q] f32
    max_logits: Optional[torch.Tensor] = None  # [heads_q] f32
