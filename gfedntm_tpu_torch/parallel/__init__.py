"""V-sharded (model-parallel) training over torch.distributed process groups."""
