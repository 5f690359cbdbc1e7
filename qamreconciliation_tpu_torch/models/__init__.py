"""Alphabet, noise mapping, parity matrix, the generic and QC decoders and
the DVB-S2 code construction."""
