"""The compact-WY panel factorization of TT1: ``house_panel``."""
