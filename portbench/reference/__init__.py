"""The plain references the benchmark holds the port to.

Plain Python, NumPy and PyTorch: nothing here imports the port or JAX, and
nothing takes what the port made. Each reference works from a stage's
definition and the configuration's settings.
"""
