"""Alphabet, noise mapping, parity matrix and the QC decoder."""
