"""Launch helpers (the port of `repro.launch`): the prefill and serve step
functions."""
