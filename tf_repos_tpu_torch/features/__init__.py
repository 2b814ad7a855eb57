"""Feature tools (counterpart of the JAX package's features/): the Criteo,
Ali-CCP, "smart" and Frappe preprocessors and the feature statistics,
host code with the JAX package's flags and output bytes."""
