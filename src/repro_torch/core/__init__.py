"""Architecture tables of the paper's CNNs (a copy of the layer specs of
``repro.core.trim.model``; the port keeps its own so it imports nothing of
the JAX package)."""
