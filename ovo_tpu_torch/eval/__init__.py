"""eval of the PyTorch port (see ovo_tpu_torch/__init__.py)."""
