"""Several devices: lane-sharded encrypted aggregation, a party's lanes and
batches over its local cards, and torch.distributed processes (port of
flashe_tpu/parallel/)."""
