"""The device mesh over torch.distributed ranks: data × model sharded
train, eval and predict steps (counterpart of the JAX package's
parallel/)."""
