"""Process groups and the collective probes."""
