"""The configuration's work per keyframe for the FLOP and roofline
arithmetic (``costs.keyframe_costs``): the SAM2 mask source and the
configuration's embedder, at the traffic's micro-batch and image size."""
from portbench.parts import sam2_amg, towers


def parts(cfg, batch, image_hw):
    return [sam2_amg.cost_part(cfg, batch, image_hw),
            towers.cost_part(cfg, batch, image_hw)]
