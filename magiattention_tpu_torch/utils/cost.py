"""Hardware cost factors: seconds per unit of mask area and per K/V row.

The port's counterpart of the JAX package's ``utils/cost.py``: the factors
the overlap timeline is priced with (``telemetry/timeline.py``,
``telemetry.record_runtime_costs``) and the roofline's peak
(``telemetry/roofline.py``), keyed by the card's name as
``torch.cuda.get_device_name`` gives it.

One row: the NVIDIA H100 SXM5 80GB HBM3 at its 700 W board power, from
NVIDIA's datasheet: 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s
HBM3 and NVLink 4 at 900 GB/s per card both ways (450 GB/s a direction).
A card that is set below 700 W runs slower than these under load.

The factors are the datasheet rates: no achievable fraction has been fitted
on the card yet, so a prediction priced with them is the floor a measurement
is held against. A card not in the table raises,
unless ``MAGI_ATTENTION_PEAK_TFLOPS`` names its peak (the calc factor and
the roofline then use that rate; the comm factor still needs the row).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CardPeakSpec:
    bf16_tflops: float  # dense bf16 tensor-core peak, TFLOP/s
    hbm_gbps: float  # HBM bandwidth, GB/s
    link_gbps: float  # NVLink bandwidth a direction, GB/s
    power_w: float  # the board power the datasheet rates are for


CARD_PEAK_SPECS = {
    "NVIDIA H100 80GB HBM3": CardPeakSpec(
        bf16_tflops=989.0, hbm_gbps=3350.0, link_gbps=450.0, power_w=700.0),
}


def current_card(device=None) -> str:
    """The name of the card ``device`` (default: the current CUDA device)
    lies on; raises without one."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: name the card (card=...) to price it")
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"{dev} is not a CUDA device: name the card (card=...) to price it")
    return torch.cuda.get_device_name(dev)


def card_spec(card: str) -> CardPeakSpec:
    spec = CARD_PEAK_SPECS.get(card)
    if spec is None:
        raise ValueError(
            f"unknown card {card!r}; known: {sorted(CARD_PEAK_SPECS)} "
            "(set MAGI_ATTENTION_PEAK_TFLOPS to its dense bf16 peak)")
    return spec


def peak_tflops(card: str) -> float:
    """The card's dense bf16 peak, or ``MAGI_ATTENTION_PEAK_TFLOPS``."""
    from .. import env

    override = env.peak_tflops_override()
    return override if override is not None else card_spec(card).bf16_tflops


def get_calc_cost_factor(num_heads_q: int, head_dim: int, card: str | None = None) -> float:
    """Seconds per unit of mask area (forward): 4 * hq * d FLOPs (two
    matrix products) over the peak."""
    card = current_card() if card is None else card
    return 4.0 * num_heads_q * head_dim / (peak_tflops(card) * 1e12)


def get_comm_cost_factor(num_heads_kv: int, head_dim: int, card: str | None = None,
                         bytes_per_elt: int = 2) -> float:
    """Seconds per K/V row moved: 2 (K and V) * hkv * d * bytes over the
    NVLink rate a direction."""
    spec = card_spec(current_card() if card is None else card)
    return 2.0 * num_heads_kv * head_dim * bytes_per_elt / (spec.link_gbps * 1e9)
