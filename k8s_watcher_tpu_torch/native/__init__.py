"""The watch-frame prefilter (the Python scanner)."""
