"""Offline tools of the PyTorch port: dataset extraction and the synthetic
action workflow."""
