"""The watch-frame prefilter: the native scanner (``fastscan.cpp``, built with
``g++`` at first use) and the Python scanner it degrades to."""
