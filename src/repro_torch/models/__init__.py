"""Architecture models in PyTorch: the port of ``repro/models`` for the
serving path (prefill and one-token decode) of the dense attention blocks."""
