"""Traffic generators (code) and traffic mixes (``<mix>.json`` data files
naming a generator and its parameters)."""
