"""Suffix-array construction core of the port (counterpart of ``repro.core``)."""
