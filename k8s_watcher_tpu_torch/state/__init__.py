"""Checkpoint/resume state: the journaled checkpoint store and dirty-key sets."""
