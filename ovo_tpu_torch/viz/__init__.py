"""The viewer of the PyTorch port (port of ``ovo_tpu/viz``)."""
from .visualizer import Visualizer, export_colored_pcd  # noqa: F401
