"""The sharding layer: rules (``spec``), strategies, and the
sequence-sharded decode attention, over ``torch.distributed``."""
