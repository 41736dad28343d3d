"""File readers of the port. Only the PROPACEOS table reader
(``io.eos``) is ported so far; the rest of the JAX package's ``io`` waits
for ROADMAP A.15."""

from synthpy_tpu_torch.io.eos import EV_TO_K, JOULE_TO_ERG, read_propaceos

__all__ = ["EV_TO_K", "JOULE_TO_ERG", "read_propaceos"]
