"""Hand-written GPU kernels for the solver's hot paths (Pallas through
Triton)."""
