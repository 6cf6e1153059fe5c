"""Data side of the port (counterpart of ``repro.data``): corpus synthesis,
the chunked on-disk store, exact-substring dedup and the deterministic loader."""
