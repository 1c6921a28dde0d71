"""Training substrate: optimizer, train step, checkpointing, data, and
gradient compression (port of ``src/repro/training``)."""
