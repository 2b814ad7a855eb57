"""Feature tools (counterpart of the JAX package's features/): so far only
the field-block layout that --field_blocks=auto:<feature_map> reads."""
