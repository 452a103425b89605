from .backbone import WrapperGaussianSLAM  # noqa: F401
