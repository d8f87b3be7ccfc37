"""Event pipeline: filter -> phase-delta -> slice tracking -> extract -> notify."""
