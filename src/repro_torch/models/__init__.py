"""Models of the port (port of ``repro.models``): the decoder-only LM with
attention and the MoE layer."""
