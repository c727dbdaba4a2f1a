"""Measurement probes of the port, run as ``python -m
rgbmanip_tpu_torch.scripts.<name>`` (counterparts of the JAX package's
``scripts/``)."""
