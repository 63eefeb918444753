"""The symmetric band matrix-vector product: ``band_mv``."""
