"""Corpus synthesis of the port (counterpart of ``repro.data``)."""
