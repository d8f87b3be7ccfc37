"""Fault injection for the collective probes."""
