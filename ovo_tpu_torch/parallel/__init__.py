"""Multi-process paths of the PyTorch port (port of ``ovo_tpu/parallel``)."""
from .mesh import make_mesh  # noqa: F401
