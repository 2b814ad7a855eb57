"""The device mesh over torch.distributed ranks: data × model sharded
train, eval and predict steps, on one host or across hosts
(--dist_mode=2) (counterpart of the JAX package's parallel/)."""
