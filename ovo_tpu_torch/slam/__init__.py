from .vanilla import VanillaMapper  # noqa: F401


def get_slam_backbone(config, dataset, cam_intrinsics, device):
    """Backbone factory: the GT-pose ``vanilla`` backbone, the native
    tracker's ``orbslam*`` tier or the ``gaussian_slam`` tier."""
    backbone = config["slam"].get("slam_module", "vanilla")
    if backbone == "gaussian_slam":
        from .gaussian import WrapperGaussianSLAM

        return WrapperGaussianSLAM(config, cam_intrinsics, device=device)
    if backbone.startswith("orbslam"):
        from .orbslam import WrapperORBSLAM

        return WrapperORBSLAM(config, cam_intrinsics,
                              world_ref=dataset[0][3], device=device)
    if backbone != "vanilla":
        raise NotImplementedError(
            f"slam_module {backbone!r} is not ported yet")
    return VanillaMapper(config, cam_intrinsics, device)
