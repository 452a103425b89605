"""SAM2 automatic masks: Hiera trunk, FPN neck, prompt encoder, two-way
decoder and the AMG program (port of ``ovo_tpu/models/sam``)."""
from .amg import build_sam_mask_source

__all__ = ["build_sam_mask_source"]
