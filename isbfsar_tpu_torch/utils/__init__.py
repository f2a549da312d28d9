"""Part of the PyTorch port (see isbfsar_tpu_torch/__init__.py)."""
