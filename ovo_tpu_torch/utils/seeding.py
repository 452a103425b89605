"""Deterministic seeding (port of ``ovo_tpu/utils/seeding.py``): python,
numpy and torch are seeded; the torch generator takes the place of the JAX
package's PRNG key."""
from __future__ import annotations

import os
import random

import numpy as np
import torch


def setup_seed(seed: int) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    os.environ.setdefault("PYTHONHASHSEED", str(seed))
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
