"""SAM automatic masks: the SAM2 (Hiera trunk, FPN neck) and SAM1 (ViT-det)
encoders, the prompt encoder, the two-way decoder and the AMG program (port
of ``ovo_tpu/models/sam``)."""
from .amg import build_sam_mask_source

__all__ = ["build_sam_mask_source"]
