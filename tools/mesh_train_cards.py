"""Training under a (2, 2) mesh over four cards, one NCCL rank a card.

Run from the repository's root on a machine with four H100s:

    python3 tools/mesh_train_cards.py

It runs ``chip_smoke.py`` phase 3k's leg (``chip_smoke.mesh_train_leg``:
moonshot-v1-16b-a3b at published width, capacity factor 11.0, bfloat16,
``MESH_TRAIN``'s batch and steps, every check of the phase) on a (2, 2)
mesh of four ranks over ``nccl``, cut to layer 0 and the most MoE layers
whose ``mesh_train_reckoning`` fits one card with ``MARGIN_GB`` to spare
(every rank holds the whole state: the global view).  The one-process
reference step runs first on card 0.  The last lines are the card's name
and power limit and a JSON object of the readings.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as smoke  # noqa: E402

#: GB of a card kept beside the reckoning for activations, the CUDA
#: context and NCCL's buffers when choosing the depth
MARGIN_GB = 8.0
MESH = {"2x2": (2, 2)}


def deepest(total_bytes: int) -> int:
    """The most MoE layers whose reckoning fits ``total_bytes``."""
    layers = 1
    while smoke.mesh_train_reckoning(smoke.mesh_train_config(layers + 1))["total"] \
            + MARGIN_GB * 1e9 <= total_bytes:
        layers += 1
    return layers


def main() -> None:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        smoke.fail("this run needs four CUDA cards")
    from repro_torch.kernels import _cuda

    dev = torch.device("cuda", 0)
    _cuda.build()
    _cuda.lib()
    card = smoke.card_line()
    layers = deepest(torch.cuda.get_device_properties(dev).total_memory)
    print(f"four ranks over nccl, one a card ({card}); layer 0 and {layers} MoE layers")
    launches, stats = smoke.mesh_train_leg(dev, card, MESH, layers, "nccl")
    print(card)
    print(json.dumps({"mesh_train_cards": stats, "launches": launches}))


if __name__ == "__main__":
    main()
