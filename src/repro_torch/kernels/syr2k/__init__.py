"""The symmetric rank-2k update of TT1: ``syr2k``."""
