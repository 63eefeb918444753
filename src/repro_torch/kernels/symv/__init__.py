"""The one-triangle symmetric product (KE1 / KI2): ``symv`` and ``symm_block``."""
