"""Dry-run analysis of the port (``repro.analysis``'s counterpart): the
roofline on H100 targets, the two-point depth correction, the collective
accounting and the report tables."""
